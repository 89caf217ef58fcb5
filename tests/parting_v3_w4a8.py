"""Where the port's W4A8 DeepSeek-V3 forward parts from the JAX package.

    JAX_PLATFORMS=cpu python tests/parting_v3_w4a8.py

On the tiny W4A8 V3 of tests/test_torch_deepseek_v3.py, with the port's
routers forced to the reference's expert sets (its _port_router), this
runs the port's forward as it is and with float32 orders of the JAX
package put into its plain versions, one alignment at a time:

- ``sum``: the RMSNorm mean of squares summed as XLA's CPU backend sums
  it (windows of 32 in sequence, then the windows in sequence), in
  rms_norm and in the fused MLA decode's plain version;
- ``prep``: the W4A8 activation prep's (and the FFN requant's) group sums
  t and xsum in that order too, and its scale as amax * (1 / 127), the
  form XLA's simplifier gives ``amax / 127`` inside a jitted kernel;
- ``rsqrt``: XLA's own rsqrt bits, fetched through jax.lax.rsqrt. No
  PyTorch op gives them (XLA's CPU backend refines the processor's
  rsqrtss estimate by two Newton steps), so this one is a probe only.

For each it prints the forced run's logits error per step against
LOGIT_TOL and the first recorded op output whose bits differ from the
JAX package's, then the facts behind the alignments. It holds nothing:
the test is test_forward_w4a8_matches_jax.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

import tests.test_torch_deepseek_v3 as V3  # noqa: E402
from tests.test_torch_model import jax_interpret_hooks  # noqa: E402

VARIANTS = ((), ("sum",), ("sum", "rsqrt"), ("sum", "prep"),
            ("sum", "prep", "rsqrt"))
# the functions whose outputs both packages record, by name
RECORDED = ("rms_norm", "plinear", "_dense_mlp", "_moe_mlp",
            "_mla_attention", "decoder_layer", "route", "moe_forward",
            "mla_absorbed")
F32_RECIP_127 = np.float32(1 / 127)


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order: windows of 32 summed in
    sequence, then the window sums in sequence (in sequence where the
    axis is no multiple of 32)."""
    d = v.shape[-1]
    w = v.reshape(*v.shape[:-1], d // 32, 32) if d % 32 == 0 else v[..., None, :]
    s = w[..., 0]
    for i in range(1, w.shape[-1]):
        s = s + w[..., i]
    t = s[..., 0]
    for j in range(1, s.shape[-1]):
        t = t + s[..., j]
    return t


def xla_rsqrt(v: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.lax.rsqrt(jnp.asarray(v.numpy()))).copy())


def aligned(variant):
    """Install the alignments of ``variant`` into the port's plain
    versions; returns the undo list."""
    from ktransformers_tpu_torch.models import model as tm
    from ktransformers_tpu_torch.ops.cuda import mla_decode as md
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as wf
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as wm
    from ktransformers_tpu_torch.quant import w4a8 as qw

    undo = []

    def put(mod, name, fn):
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    rsqrt = xla_rsqrt if "rsqrt" in variant else torch.rsqrt

    def mean_sq(xf):
        return (xla_sum(xf * xf) / xf.shape[-1])[..., None]

    if "sum" in variant or "rsqrt" in variant:
        def rms_norm(x, weight, eps=1e-6):
            xf = x.to(torch.float32)
            var = (mean_sq(xf) if "sum" in variant
                   else (xf * xf).mean(-1, keepdim=True))
            return (xf * rsqrt(var + eps) * weight.to(torch.float32)).to(x.dtype)

        put(tm, "rms_norm", rms_norm)
        # the fused MLA decode's plain version norms the new cache row
        # inline: the same function, recompiled with the two swapped in
        import inspect

        src = inspect.getsource(md.mla_decode_fused_ref)
        if "sum" in variant:
            src = src.replace(
                "ms = (ckv_raw * ckv_raw).mean(dim=-1, keepdim=True)",
                "ms = mean_sq(ckv_raw)")
        src = src.replace("torch.rsqrt(ms + eps)", "rsqrt(ms + eps)")
        ns = dict(md.__dict__, mean_sq=mean_sq, rsqrt=rsqrt)
        exec(src, ns)
        put(md, "mla_decode_fused_ref", ns["mla_decode_fused_ref"])

    if "prep" in variant:
        def quant_rows(v):
            amax = torch.clamp(v.abs().amax(dim=-1), min=1e-8)
            s = amax * F32_RECIP_127
            codes = torch.clamp(torch.round(v / s[..., None]), -127, 127)
            return codes.to(torch.int8), s

        def prep(x2, kdim, group_size):
            m = x2.shape[0]
            gs = group_size or kdim
            ng, gs2 = kdim // gs, gs // 2
            xl, xh = qw.split_x_for_int4(x2, kdim, group_size)
            xlf = xl.to(torch.float32).reshape(m, ng, gs2)
            xhf = xh.to(torch.float32).reshape(m, ng, gs2)
            qa, sa = quant_rows(xlf - xhf / 16.0)
            qb, sb = quant_rows(xhf / 16.0)
            return (qa.reshape(m, kdim // 2), qb.reshape(m, kdim // 2), sa,
                    sb, 8.0 * xla_sum(xlf), xla_sum(xlf + xhf))

        def requant_groups(a, gs, xsum=False):
            m, inter = a.shape
            seg = a.reshape(m, inter // gs, gs)
            lo, hi = seg[..., : gs // 2], seg[..., gs // 2:]
            ca, sa = quant_rows(lo - hi / 16.0)
            cb, sb = quant_rows(hi / 16.0)
            out = (ca.reshape(m, inter // 2), cb.reshape(m, inter // 2), sa,
                   sb, 8.0 * xla_sum(lo))
            return out + (xla_sum(lo + hi),) if xsum else out

        for mod in (qw, wm, wf):
            put(mod, "w4a8_prep", prep)
        put(wf, "requant_groups", requant_groups)
    return undo


def recorded(mod, rec):
    """Wrap RECORDED functions of ``mod`` to append (name, output index,
    float32 numpy) of each call to ``rec``; returns the undo list."""
    undo = []

    def flat(out):
        if isinstance(out, tuple):
            return [y for o in out for y in flat(o)]
        if isinstance(out, torch.Tensor):
            return [out.detach().float().numpy()]
        return [np.asarray(out, np.float32)] if hasattr(out, "shape") else []

    for name in RECORDED:
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def wrap(*a, _name=name, _fn=fn, **kw):
            out = _fn(*a, **kw)
            rec.extend((_name, i, x) for i, x in enumerate(flat(out)))
            return out

        undo.append((mod, name, fn))
        setattr(mod, name, wrap)
    return undo


def restore(undo):
    for mod, name, fn in reversed(undo):
        setattr(mod, name, fn)


def first_parting(jrec, trec):
    """The first JAX record (in call order) whose bits the port's record
    of the same function, output and call differs from."""
    def streams(rec):
        out = {}
        for k, (name, i, x) in enumerate(rec):
            out.setdefault((name, i), []).append((k, x))
        return out

    jst, tst = streams(jrec), streams(trec)
    best = None
    for key in set(jst) & set(tst):
        for call, ((k, a), (_, b)) in enumerate(zip(jst[key], tst[key])):
            if a.shape != b.shape or not np.array_equal(a, b):
                if best is None or k < best[0]:
                    rel = (float(np.abs(a - b).max() / np.abs(a).max())
                           if a.shape == b.shape else float("nan"))
                    best = (k, key, call, rel, int((a != b).sum()), a.size)
                break
    return best


def main() -> None:
    from ktransformers_tpu.models import model as jm
    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS
    from ktransformers_tpu_torch.convert import params_from_jax
    from ktransformers_tpu_torch.models import model as tm

    torch.set_num_threads(1)
    with jax_interpret_hooks():
        def pallas_only(fn):
            return lambda x, w, arg: fn(x, w, arg) if w.kind in PALLAS_KINDS else None

        jmoe.set_pallas_gather(pallas_only(jmoe._PALLAS_GATHER))
        jmoe.set_pallas_gmm(pallas_only(jmoe._PALLAS_GMM))
        jspec, jparams = V3._jax_params("int4_g")
        params = params_from_jax(jax.device_get(jparams), V3.SPEC, "cpu")
        tokens = V3._tokens()
        jrec = []
        undo = recorded(jm, jrec)
        try:
            V3._jax_run(jspec, jparams, tokens, V3.FEED)
        finally:
            restore(undo)
        for variant in VARIANTS:
            undo = aligned(variant)
            try:
                (ref, _, ref_calls), _, (out, _, _) = V3._routed_runs(
                    jspec, jparams, params, tokens)
                trec = []
                rec_undo = recorded(tm, trec)
                try:
                    with V3._port_router(ref_calls):
                        V3._port_run(params, tokens, V3.FEED)
                finally:
                    restore(rec_undo)
            finally:
                restore(undo)
            errs = [V3._rel(a, b) for a, b in zip(out, ref)]
            k, key, call, rel, n, size = first_parting(jrec, trec)
            print(f"aligned {'+'.join(variant) or 'none'}: forced logits "
                  f"error per step {['%.3e' % e for e in errs]}, max "
                  f"{max(errs):.3e} (LOGIT_TOL {V3.LOGIT_TOL}); first "
                  f"parting: JAX record {k}, {key[0]} output {key[1]} call "
                  f"{call}, {n} of {size} elements, rel {rel:.3e}")

    rng = np.random.default_rng(1)
    for d in (64, 128, 256):
        x = rng.standard_normal((256, d)).astype(np.float32)
        want = np.asarray(jnp.mean(jnp.asarray(x) ** 2, axis=-1))
        got = (xla_sum(torch.from_numpy(x) ** 2) / d).numpy()
        mean = (torch.from_numpy(x) ** 2).mean(-1).numpy()
        print(f"mean of squares, width {d}: XLA-order sum equal to "
              f"jnp.mean in {np.mean(got == want):.4f} of rows, torch's "
              f"mean in {np.mean(mean == want):.4f}")
    v = rng.uniform(1e-4, 10.0, 40000).astype(np.float32)
    jr = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(v)))
    exact = (1 / np.sqrt(v.astype(np.float64))).astype(np.float32)
    print(f"rsqrt: torch.rsqrt equal to XLA's in "
          f"{np.mean(torch.rsqrt(torch.from_numpy(v)).numpy() == jr):.4f}; "
          f"correctly rounded: XLA {np.mean(jr == exact):.4f}, torch "
          f"{np.mean(torch.rsqrt(torch.from_numpy(v)).numpy() == exact):.4f}")
    a = v[:20000]
    j = np.asarray(jax.jit(lambda t: t / 127.0)(jnp.asarray(a)))
    print(f"jitted a / 127 equal to a * (1 / 127) in "
          f"{np.mean(j == a * F32_RECIP_127):.4f}, to a / 127 in "
          f"{np.mean(j == a / np.float32(127)):.4f}")


if __name__ == "__main__":
    main()
