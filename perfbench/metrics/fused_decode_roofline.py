"""Kernels: ``fused_decode``'s share of its roofline over the traced slice:
the least time of its calls (the larger of their bytes at the HBM peak and
their operations at the f32 peak, ``work.fused_decode_work``) over their
kernel time, in %.  A captured call runs over all ``n_slots`` rows; its
gather is priced at the count rows that the megastep's active slots, and
one row for all the free ones, touch in expectation (the indices never
reach the host), so that free slots hashing alike are not counted as
reads."""

from perfbench import work


def read(w):
    if w.trace is None:
        return None
    calls = w.trace.kernels_named("fused_decode")
    if not calls:
        return None
    n = w.mix.n_slots
    steps = w.trace.annotated("pb.megastep:")
    least = 0.0
    for k in calls:
        around = [a for a in steps if a.start <= k.start < a.end]
        active = (int(around[-1].name.split(":")[1].split("x")[1]) if around
                  else n)
        rows = work.expected_rows(w.head["n_rows"], w.head["n_buckets"],
                                  active + (active < n))
        n_bytes, ops = work.fused_decode_work(n, w.cfg["d_model"], w.head,
                                              w.cfg["vocab_size"], rows)
        least += max(n_bytes / work.PEAK_BYTES, ops / work.PEAK_F32)
    return 100.0 * least / sum(k.end - k.start for k in calls)
