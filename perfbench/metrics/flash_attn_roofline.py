"""Kernels: the flash-attention forward's share of its roofline over the
traced slice: for every prefill annotated there (``pb.prefill:<G>x<P>``),
the least time of each ``flash_attn`` kernel it launched (the larger of
``work.flash_attn_work``'s bytes at the HBM peak and its operations at the
bf16 tensor-core peak) over their kernel time, in %."""

from perfbench import work


def read(w):
    if w.trace is None or w.cfg["kind"] != "attn":
        return None
    a = w.cfg["attention"]
    kernels = [k for k in w.trace.kernels_named("flash_attn")
               if "bwd" not in k.name and "dkdv" not in k.name
               and "dq_" not in k.name]
    least = busy = 0.0
    for note in w.trace.annotated("pb.prefill:"):
        g, p = (int(x) for x in note.name.split(":")[1].split("x"))
        mine = w.trace.within(kernels, note)
        n_bytes, ops = work.flash_attn_work(g, p, a["n_heads"], a["n_kv_heads"],
                                            a["head_dim"], None, 2)
        least += len(mine) * max(n_bytes / work.PEAK_BYTES,
                                 ops / work.PEAK_BF16)
        busy += sum(k.end - k.start for k in mine)
    return 100.0 * least / busy if busy else None
