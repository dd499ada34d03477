"""The port's gradients against the JAX package's: the attention backward
and ``lm_loss``'s grads for every family of the registry.

Inputs are made with numpy from a seed and handed to both packages; params
come from the JAX package's init through ``convert.params_from_numpy``.
Tolerances:

* The plain attention backward (``flash_attention_bwd_ref``: explicit
  formulas from the forward's output and row log-sum-exp) against
  ``jax.vjp`` of the JAX package's ``flash_attention_ref`` (GQA keys and
  values expanded for JAX, their grads summed over each group) and
  against torch autograd of the plain forward, in f32: within
  ``repro_torch.parity.flash_attn_bwd_tol``, the bound of two f32
  evaluations of the gradient (autodiff's softmax vjp sums p·dp where the
  formulas sum dout·out; both are f32 sums of the same exact value).
* ``lm_loss`` and its grads against ``jax.value_and_grad`` of the JAX
  package's, compiled with XLA's ``xla_allow_excess_precision`` off (each
  bf16 op rounds where the program says, as it does op by op; with excess
  precision XLA's Mamba scan moves jamba's residual 3 % at its first
  layer): each grad leaf under ``parity``'s bf16 backbone rule (2⁻⁵
  relative in norm, 2⁻⁴ of the largest magnitude: the backward is a bf16
  network too, its sums in other orders), ce within one bf16 ulp (2⁻⁸)
  relative.  MoE routing is a
  threshold: every token routed otherwise than by the JAX package (at
  the JAX layer's own input, captured with ``jax.debug.callback``) must be
  explained by the two residuals (``parity``'s router rule, as
  tests/test_torch_model.py holds the forward); such batch rows are then
  masked out of the loss (labels -1) on both sides before the grads are
  compared, and the aux loss may differ by what the flipped tokens move
  it (each moves two experts' token fractions by 1/N).
* Remat on against remat off: bit for bit (the recompute repeats the
  forward's arithmetic).
* The backward kernel's tensor-core path, emulated in plain torch (its
  product structure: unscaled q·k then the scale, p·2¹⁶ and ds·2¹⁶ split
  into three bf16 terms, products summed per 16-wide k-step in f32, dk's
  and dq's scale after the sum) on bf16-valued inputs, against the plain
  backward: within ``flash_attn_bwd_tol``'s tensor-core form, which is
  at least its f32 form everywhere; the split itself exact over every f32
  binade of ds.

The ``cuda`` cases hold the backward kernel against the plain backward on
the card and skip here; JAX is imported inside fixtures, so they also run
where JAX is not installed (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_bwd_ref,
                                                flash_attention_lse,
                                                flash_attention_lse_ref,
                                                flash_attention_ref)
from repro_torch.models import blocks, model
from repro_torch.parity import (BF16_MAX_TOL, BF16_NORM_TOL,
                                assert_flash_attn_close,
                                bf16_backbone_errors, flash_attn_bwd_tol,
                                flash_attn_tol_ratio)
from test_torch_attention import _f32_at_every_exponent, split_bf16

BF16_ULP = 2.0 ** -8
# (B, S, H, Hkv, dh, window, softcap): MHA and GQA, windowed or not, with
# and without a softcap, a band that starts mid-tile.
BWD_CASES = [(2, 24, 4, 4, 16, None, None), (2, 40, 4, 2, 16, 8, None),
             (1, 33, 6, 2, 32, None, 30.0), (2, 50, 4, 1, 16, 7, 5.0)]
# (arch, batch, seq): gemma2's sequence passes window + 1024, so the JAX
# package's training forward takes _attend_banded on its local layers.
FAMILIES = [("rwkv6-1.6b", 2, 16), ("gemma2-27b", 1, 1040),
            ("mixtral-8x7b", 4, 12), ("jamba-v0.1-52b", 3, 12),
            ("deepseek-v3-671b", 4, 12), ("llama-3.2-vision-11b", 2, 16),
            ("musicgen-large", 2, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (its tensors are small):
    the suite runs several test processes on one machine, and torch's
    default of a thread per core each makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as config
    from repro.kernels.flash_attn.ref import flash_attention_ref as flash_ref
    from repro.models import blocks as jblocks
    from repro.models import model as jmodel
    return dict(jax=jax, jnp=jnp, config=config, flash_ref=flash_ref,
                blocks=jblocks, model=jmodel)


def _attn_inputs(b, s, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    return q, k, v, dout


def _assert_grads_close(got, want, tols):
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, tols):
        assert_flash_attn_close(g, w, t, name=f"attention backward {name}")


@pytest.mark.parametrize("b,s,h,hkv,dh,window,cap", BWD_CASES)
def test_bwd_ref_matches_jax_vjp(jx, b, s, h, hkv, dh, window, cap):
    """``flash_attention_bwd_ref`` against ``jax.vjp`` of the JAX package's
    plain attention (KV expanded; dk, dv summed over each group)."""
    jnp = jx["jnp"]
    q, k, v, dout = _attn_inputs(b, s, h, hkv, dh)
    g = h // hkv
    ke, ve = (jnp.repeat(jnp.asarray(t), g, axis=2) for t in (k, v))
    _, vjp = jx["jax"].vjp(lambda a, bb, c: jx["flash_ref"](
        a, bb, c, window=window, softcap=cap), jnp.asarray(q), ke, ve)
    jdq, jdk, jdv = (np.asarray(t) for t in vjp(jnp.asarray(dout)))
    jdk = jdk.reshape(b, s, hkv, g, dh).sum(3)
    jdv = jdv.reshape(b, s, hkv, g, dh).sum(3)
    qt, kt, vt, dt = (torch.from_numpy(t) for t in (q, k, v, dout))
    out, lse = flash_attention_lse_ref(qt, kt, vt, window=window, softcap=cap)
    got = flash_attention_bwd_ref(qt, kt, vt, out, dt, lse, window=window,
                                  softcap=cap)
    want = [torch.from_numpy(np.array(t)) for t in (jdq, jdk, jdv)]
    _assert_grads_close(got, want, flash_attn_bwd_tol(qt, kt, vt, out, dt,
                                                      lse, window, cap))


@pytest.mark.parametrize("b,s,h,hkv,dh,window,cap", BWD_CASES)
def test_flash_autograd_matches_autograd_of_plain(b, s, h, hkv, dh, window,
                                                  cap):
    """``flash_attention`` under autograd (its forward with lse, its
    backward the plain formulas on the CPU) against torch autograd of the
    plain forward: the same output bits, grads within the bound."""
    q, k, v, dout = (torch.from_numpy(t) for t in _attn_inputs(b, s, h, hkv,
                                                               dh, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, window=window, softcap=cap)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*plain, window=window, softcap=cap)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, plain, dout)
    _, lse = flash_attention_lse_ref(q, k, v, window=window, softcap=cap)
    _assert_grads_close(got, want, flash_attn_bwd_tol(q, k, v, out.detach(),
                                                      dout, lse, window, cap))
    with torch.no_grad():
        assert flash_attention(*leaves, window=window,
                               softcap=cap).grad_fn is None


def test_lse_ref_is_the_rows_logsumexp():
    """The plain lse is log Σ exp of each row's live scores (f64 check) and
    the output beside it is ``flash_attention_ref``'s, bit for bit."""
    q, k, v, _ = (torch.from_numpy(t) for t in _attn_inputs(2, 20, 4, 2, 16))
    out, lse = flash_attention_lse_ref(q, k, v, window=5, softcap=20.0)
    assert torch.equal(out, flash_attention_ref(q, k, v, window=5,
                                                softcap=20.0))
    qs = (q.double() * 16 ** -0.5).reshape(2, 20, 2, 2, 16)
    s = 20.0 * torch.tanh(torch.einsum("bqkgd,bskd->bkgqs", qs, k.double())
                          / 20.0)
    i = torch.arange(20)
    live = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 5)
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), -1)
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 4, 20).numpy(),
                               rtol=1e-6, atol=1e-6)


# -- the backward kernel's tensor-core arithmetic, in plain torch ----------


def test_bwd_split_of_ds_is_exact():
    """The dK/dV and dQ kernels' premise: ``split_bf16`` of ds·2¹⁶ sums to
    it exactly for ds of every f32 binade, signed, subnormals included, up
    to |ds| < 2¹¹² (ds·2¹⁶ at most bf16's largest finite value; above it
    hi overflows)."""
    rng = np.random.default_rng(25)
    ds = _f32_at_every_exponent(rng, range(0, 127 + 112))
    x = ds * 2.0 ** 16
    assert torch.equal(x.to(torch.float64), ds.to(torch.float64) * 2.0 ** 16)
    keep = x.abs() <= torch.finfo(torch.bfloat16).max
    assert float(keep.float().mean()) > 0.99
    ds, x = ds[keep], x[keep]
    assert bool((ds < 0).any()) and bool(((ds != 0) & (ds.abs() < 2.0 ** -126)).any())
    hi, mid, lo = split_bf16(x)
    total = sum(t.to(torch.float64) for t in (hi, mid, lo))
    assert torch.equal(total, x.to(torch.float64))


def _kstep_sum(pairs):
    """f32 sum of ``einsum(spec, a, b)`` over the given 16-wide slices, in
    order: each k-step's products summed in f32, then added to the f32
    accumulator."""
    acc = None
    for spec, a, b in pairs:
        part = torch.einsum(spec, a, b)
        acc = part if acc is None else acc + part
    return acc


def _split_terms(x):
    return [t.to(torch.float32) for t in split_bf16(x * 2.0 ** 16)]


def _tc_bwd_emulation(q, k, v, out, dout, lse, window, cap):
    """``(dq, dk, dv)`` by the tensor-core kernels' product structure, in
    f32 on bf16-valued f32 inputs: s = Σ q·k (16-wide k-steps) times
    RN(dh^-0.5) (or tanh of it times RN(dh^-0.5 / softcap)); dp likewise;
    p, ds by the reference's formulas; dv, dk, dq from the three bf16
    terms of p·2¹⁶ and ds·2¹⁶ over 16-wide k-steps (per query head, for dk
    and dv), times 2⁻¹⁶ (dk and dq: RN(dh^-0.5)·2⁻¹⁶) after the sum."""
    f32 = torch.float32
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = torch.tensor(dh ** -0.5, dtype=f32)
    qg = q.reshape(b, s, hkv, g, dh)
    dog = dout.reshape(b, s, hkv, g, dh)
    steps_d = range(0, dh, 16)
    s_raw = _kstep_sum(("bqkgd,bskd->bkgqs", qg[..., i:i + 16], k[..., i:i + 16])
                       for i in steps_d)
    dp = _kstep_sum(("bqkgd,bskd->bkgqs", dog[..., i:i + 16], v[..., i:i + 16])
                    for i in steps_d)
    t = None
    if cap:
        t = torch.tanh(s_raw * (scale / cap))
        s_c = cap * t
    else:
        s_c = s_raw * scale
    pos = torch.arange(s)
    live = pos[:, None] >= pos[None, :]
    if window is not None:
        live &= (pos[:, None] - pos[None, :]) < window
    p = torch.exp(s_c - lse.reshape(b, hkv, g, s, 1))
    d_row = (dog * out.reshape(b, s, hkv, g, dh)).sum(-1)
    ds = p * (dp - d_row.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    p, ds = (torch.where(live, x, torch.zeros(())) for x in (p, ds))
    p_terms, ds_terms = _split_terms(p), _split_terms(ds)
    steps_q = [(gi, i) for gi in range(g) for i in range(0, s, 16)]
    dv = _kstep_sum(("bkqs,bqkd->bskd", term[:, :, gi, i:i + 16],
                     dog[:, i:i + 16, :, gi]) for gi, i in steps_q for term in p_terms)
    dk = _kstep_sum(("bkqs,bqkd->bskd", term[:, :, gi, i:i + 16],
                     qg[:, i:i + 16, :, gi]) for gi, i in steps_q for term in ds_terms)
    dq = _kstep_sum(("bkgqs,bskd->bqkgd", term[..., i:i + 16], k[:, i:i + 16])
                    for i in range(0, s, 16) for term in ds_terms)
    back = scale * 2.0 ** -16
    return dq.reshape(b, s, h, dh) * back, dk * back, dv * 2.0 ** -16


def _bf16_valued(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).to(torch.float32)
            for a in arrays]


@pytest.mark.parametrize("b,s,h,hkv,dh,window,cap", BWD_CASES)
def test_tc_bwd_emulation_within_tensor_core_bound(b, s, h, hkv, dh, window,
                                                   cap):
    """The kernel's tensor-core arithmetic, emulated in f32, against the
    plain backward on the same bf16-valued inputs: within
    ``flash_attn_bwd_tol(tensor_cores=True)`` at every element."""
    q, k, v, dout = _bf16_valued(*_attn_inputs(b, s, h, hkv, dh, seed=3))
    out, lse = flash_attention_lse_ref(q, k, v, window=window, softcap=cap)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window,
                                   softcap=cap)
    got = _tc_bwd_emulation(q, k, v, out, dout, lse, window, cap)
    tols = flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap,
                              tensor_cores=True)
    _assert_grads_close(got, want, tols)
    assert not any(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("b,s,h,hkv,dh,window,cap", BWD_CASES)
def test_tensor_core_bwd_bound_covers_the_f32_one(b, s, h, hkv, dh, window,
                                                  cap):
    """``flash_attn_bwd_tol(tensor_cores=True)`` is finite and at least the
    f32 form at every element of dq, dk and dv."""
    q, k, v, dout = (torch.from_numpy(t) for t in _attn_inputs(b, s, h, hkv,
                                                               dh, seed=4))
    out, lse = flash_attention_lse_ref(q, k, v, window=window, softcap=cap)
    f32 = flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap,
                             tensor_cores=False)
    tc = flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap,
                            tensor_cores=True)
    assert flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap)[0].equal(f32[0])
    for x, y in zip(tc, f32):
        assert bool(torch.isfinite(x).all())
        assert bool((x >= y).all())


def test_backward_source_builds_in_four_parts():
    """``_build`` compiles ``csrc/flash_attn_bwd.cu`` as four translation
    units at once (its ``// BUILD_PARTS 4`` line: the tensor-core kernels
    of 16 dh values, the long pole of the build) and every other source as
    one."""
    from repro_torch.kernels import _build
    assert _build._parts("flash_attn_bwd") == 4
    assert all(_build._parts(n) == 1 for n in _build.sources()
               if n != "flash_attn_bwd")


# -- lm_loss and its grads for every family --------------------------------


def _setup(jx, arch, b, s):
    jax = jx["jax"]
    jcfg, cfg = jx["config"](arch, smoke=True), get_config(arch, smoke=True)
    jparams = jx["model"].init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                  # masked positions
    enc = None
    if cfg.n_encoder_tokens:
        enc = rng.standard_normal((b, cfg.n_encoder_tokens,
                                   cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params, toks[:, :-1], labels, enc


def _router_masks(x, router, k):
    logits = torch.from_numpy(x).double() @ torch.from_numpy(router).double()
    return logits >= torch.topk(logits, k, dim=-1).values[..., -1:]


def _assert_flip_explained(xp, xj, router, k, tokens):
    """A routing that differs between the port's and the JAX package's
    input to one MoE layer may differ only where the exact top-k gap at
    the JAX input is within what the two inputs move the logits (twice
    the largest change) plus both f32 bounds (``parity.router_tol``)."""
    from repro_torch.parity import router_tol
    r = torch.from_numpy(router)
    lj, tj = router_tol(torch.from_numpy(xj), r)
    lp, tp = router_tol(torch.from_numpy(xp), r)
    top = torch.topk(lj, k + 1, dim=-1).values
    gap = top[..., k - 1] - top[..., k]
    moved = 2.0 * (lp - lj).abs().amax(dim=-1) + tj + tp
    assert bool((gap[tokens] <= moved[tokens]).all()), (
        f"routing differs at tokens whose top-{k} gap {gap[tokens]} exceeds "
        f"what the inputs explain {moved[tokens]}")


def _flipped_rows(tlog, jlog, k):
    """Batch rows where the port routes a token otherwise than the JAX
    package at some MoE layer, each flip explained by the two inputs;
    and the number of flipped tokens."""
    rows = None
    for xp, (xj, router) in zip(tlog, jlog):
        diff = (_router_masks(xp, router, k) != _router_masks(xj, router,
                                                              k)).any(-1)
        if bool(diff.any()):
            _assert_flip_explained(xp, xj, router, k, diff)
        r = diff.reshape(xp.shape[0], -1).any(-1)
        rows = r if rows is None else rows | r
    n_flips = 0
    for xp, (xj, router) in zip(tlog, jlog):
        n_flips += int((_router_masks(xp, router, k)
                        != _router_masks(xj, router, k)).any(-1).sum())
    return rows, n_flips


def _jax_grads(jx, jcfg, jparams, toks, labels, enc, jlog):
    """``jax.value_and_grad`` of the JAX package's lm_loss, compiled
    without excess precision, with each MoE layer's input captured (the
    forward's calls come first).  Returns the compiled function of
    (params, tokens, labels) too."""
    jax, jnp, jblocks = jx["jax"], jx["jnp"], jx["blocks"]
    inner = jblocks.moe_ffn

    def recording(p, h, c):
        jax.debug.callback(
            lambda x, r: jlog.append((np.asarray(x), np.asarray(r))),
            h.astype(jnp.float32), p["router"])
        return inner(p, h, c)

    jblocks.moe_ffn = recording
    try:
        grad_fn = jax.value_and_grad(
            lambda p, t, l: jx["model"].lm_loss(
                p, t, l, jcfg,
                encoder_states=None if enc is None else jnp.asarray(enc)),
            has_aux=True)
        args = (jparams, jnp.asarray(toks), jnp.asarray(labels))
        fn = jax.jit(grad_fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        (loss, parts), grads = fn(*args)
        jax.effects_barrier()
    finally:
        jblocks.moe_ffn = inner
    return fn, float(loss), {k: float(v) for k, v in parts.items()}, grads


def _port_loss_and_grads(cfg, params, toks, labels, enc, remat=True):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in _leaves(params)]
    p = _like(params, iter(leaves))
    loss, parts = model.lm_loss(p, torch.from_numpy(toks),
                                torch.from_numpy(labels), cfg,
                                encoder_states=None if enc is None
                                else torch.from_numpy(enc), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss, parts, _like(params, iter(grads))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, it) for v in tree)
    return next(it)


def _port_moe_inputs(cfg, params, toks, enc, monkeypatch):
    log = []
    inner = blocks.moe_ffn

    def recording(p, h, c):
        log.append(h.detach().float().numpy())
        return inner(p, h, c)

    monkeypatch.setattr(blocks, "moe_ffn", recording)
    with torch.no_grad():
        model.lm_loss(params, torch.from_numpy(toks),
                      torch.zeros(toks.shape, dtype=torch.int32), cfg,
                      encoder_states=None if enc is None
                      else torch.from_numpy(enc), remat=False)
    monkeypatch.setattr(blocks, "moe_ffn", inner)
    return log


@pytest.mark.parametrize("arch,b,s", FAMILIES)
def test_lm_loss_and_grads_match_jax(jx, arch, b, s, monkeypatch):
    """The port's ``lm_loss`` (remat on, attention through the flash
    wrapper and its backward) and every grad leaf against
    ``jax.value_and_grad`` of the JAX package's ``lm_loss``."""
    jax = jx["jax"]
    jcfg, cfg, jparams, params, toks, labels, enc = _setup(jx, arch, b, s)
    jlog = []
    fn, jloss, jparts, jgrads = _jax_grads(jx, jcfg, jparams, toks, labels,
                                           enc, jlog)
    n_flips, n_tokens = 0, toks.size
    if cfg.moe is not None:
        tlog = _port_moe_inputs(cfg, params, toks, enc, monkeypatch)
        assert len(tlog) > 0 and len(jlog) >= len(tlog)
        rows, n_flips = _flipped_rows(tlog, jlog[:len(tlog)], cfg.moe.top_k)
        if rows is not None and bool(rows.any()):
            assert not bool(rows.all()), "every row routed otherwise"
            labels = labels.copy()
            labels[rows.numpy()] = -1
            (jl, jp), jgrads = fn(jparams, jx["jnp"].asarray(toks),
                                  jx["jnp"].asarray(labels))
            jloss, jparts = float(jl), {k: float(v) for k, v in jp.items()}
    loss, parts, grads = _port_loss_and_grads(cfg, params, toks, labels, enc)
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    assert abs(float(parts["ce"]) - jparts["ce"]) <= BF16_ULP * abs(
        jparts["ce"])
    aux_tol = BF16_ULP * abs(jparts["aux"])
    if n_flips:
        aux_tol += 2.0 * cfg.moe.n_experts / cfg.moe.top_k * n_flips / n_tokens
    assert abs(float(parts["aux"]) - jparts["aux"]) <= aux_tol
    assert float(loss) == pytest.approx(float(parts["ce"])
                                        + 0.01 * float(parts["aux"]),
                                        rel=1e-6)
    worst = []
    for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
        t = grads
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(jx["jnp"].asarray(jg).astype(jx["jnp"].float32))
        got = t.float().numpy()
        assert got.shape == want.shape
        key = jax.tree_util.keystr(path)
        norm_err, max_err = bf16_backbone_errors(got, want)
        worst.append((norm_err, key))
        assert norm_err <= BF16_NORM_TOL and max_err <= BF16_MAX_TOL, (
            f"{arch} grad {key}: {norm_err:.3g} in norm, {max_err:.3g} of "
            f"the largest magnitude")
    assert worst


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma2-27b"])
def test_remat_equals_no_remat(arch):
    """lm_loss and its grads with each period rematerialized equal the
    plain forward's bit for bit (two periods of a two-position pattern)."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.scaled(n_layers=2 * len(cfg.pattern))
    params = model.init_model(cfg, torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    a = _port_loss_and_grads(cfg, params, toks, labels, None, remat=True)
    b = _port_loss_and_grads(cfg, params, toks, labels, None, remat=False)
    assert torch.equal(a[0], b[0])
    for x, y in zip(_leaves(a[2]), _leaves(b[2])):
        assert torch.equal(x, y)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash_attn_bwd kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dout_scale", [1.0, 2.0 ** -40, 2.0 ** 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,dh,window,cap",
                         [(2, 130, 4, 2, 64, None, None),
                          (1, 200, 8, 4, 128, 64, 50.0),
                          (2, 70, 4, 4, 160, None, 30.0),
                          (1, 40, 2, 2, 192, 17, None),
                          (1, 100, 8, 1, 256, None, None),
                          (2, 150, 16, 2, 96, 40, 20.0)])
def test_cuda_bwd_kernel_matches_plain(cuda, dtype, dout_scale, b, s, h, hkv,
                                       dh, window, cap):
    """The kernel against the plain backward on the same q, k, v, out,
    dout and lse, within ``flash_attn_bwd_tol`` (bf16: its tensor-core
    form); two launches bit for bit; the forward's output bits unchanged
    by writing lse.  The cases cover each register regime of the
    tensor-core kernels (streamed tiles of 64 positions to dh 128, 32
    above; dh 256's 128 accumulators a thread), S not a multiple of the
    key tile, GQA groups of 2, 4 and 8, and dout scaled far down and up
    (ds·2¹⁶ splits exactly over that range)."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(s)
    q, dout = (torch.randn((b, s, h, dh), generator=g, device=cuda).to(dtype)
               for _ in range(2))
    dout = dout * dout_scale
    k, v = (torch.randn((b, s, hkv, dh), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    out, lse = flash_attention_lse(q, k, v, window=window, softcap=cap)
    assert torch.equal(out, flash_attention(q, k, v, window=window,
                                            softcap=cap))
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, dout, lse, window=window,
                              softcap=cap)
    again = flash_attention_bwd(q, k, v, out, dout, lse, window=window,
                                softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window,
                                   softcap=cap)
    tols = flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap)
    for x, y, t in zip(got, want, tols):
        assert x.dtype == dtype
        assert flash_attn_tol_ratio(x, y, t) <= 1.0


@pytest.mark.cuda
def test_cuda_bwd_raises_on_unaligned_bf16(cuda):
    """The bf16 kernels load q, k, v and dout with TMA: an operand whose
    data is not 16-byte aligned is refused before any launch."""
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v, dout = (torch.randn((1, 64, 2, 64), generator=g, device=cuda)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention_lse(q, k, v)
    flat = torch.empty(dout.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(dout.shape)
    shifted.copy_(dout)
    launches = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, out, shifted, lse)
    assert flash_attention_bwd.launches == launches


@pytest.mark.cuda
def test_cuda_flash_autograd_runs_the_kernels(cuda):
    """Grads through ``flash_attention`` on the card launch the forward
    kernel once and the backward kernel once, and give wq-style leaves a
    gradient (the kernel's output is not detached)."""
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 64, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))
