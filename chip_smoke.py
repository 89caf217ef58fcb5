"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
1. card:    nvidia-smi name and power limit;
2. build:   nvcc builds every kernel source in ktransformers_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card at
            the DeepSeek-V2-Lite shapes of the main path, with times;
4. parity:  the full-width config cut to 2 layers (one dense, one MoE), the
            same synthetic weights on the CPU (plain versions) and on the
            card (kernels), float32 compute: a 64-token prefill and 4
            decode steps;
5. serve:   the full 27-layer config (int4_g weights) in a Generator at
            max_len 1024 answering 3 requests of 512 seeded prompt tokens
            and 32 greedy new tokens; every kernel must launch;
6. profile: one prefill chunk and one decode step of that Generator: wall
            time, launches per step, device time by kernel (torch.profiler).
Prints a kernels JSON line, the card line, and as the last line
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
OUT_DIR = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call time between CUDA events, with the L2 cache flushed
    before each call (the weights of one layer are cold when its step comes
    around). The 256 MB flush keeps the device busy while the host enqueues
    the call, so for a bare kernel launch this is device time."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bench_model_cfg():
    from ktransformers_tpu_torch.models.spec import DEEPSEEK_V2_LITE

    return dict(DEEPSEEK_V2_LITE)


# ---------------------------------------------------------------- kernels


def kernel_checks(rows: list, entries: dict) -> None:
    """Each kernel through its public wrapper against its plain version on
    the same inputs. ms times the kernel launch alone on prepared operands
    (the wrapper's launcher); wrapper_ms times the whole wrapper call
    (activation prep, tile maps, allocation, host work included)."""
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.rope import (
        RopeConfig,
        precompute_rope_tables,
        rope_rotation_matrix,
    )
    from ktransformers_tpu_torch.quant.formats import dequantize
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    dev = torch.device("cuda")
    rd = _Draw(1234, dev, torch.bfloat16)
    bf = torch.bfloat16

    def w(shape, gs=128):
        return repack_offset_lo(rd.q(shape, "int4_g", gs))

    def rn(*s):
        return torch.randn(*s, device=dev, generator=rd.gen).to(bf)

    def check(name, label, tol, wrapper, plain, launcher, b_bytes, ops,
              peak, library=None, main=False, plain_iters=5, side_tol=None,
              expect=None):
        """expect (default plain) gives what the wrapper is held to; plain
        is what plain_ms times on the card."""
        out, ref = wrapper(), (expect or plain)()
        if isinstance(out, tuple):
            for o, rf in zip(out[1:], ref[1:]):
                if rel_err(o, rf)[1] > (side_tol or tol):
                    raise AssertionError(f"{name} [{label}] side outputs")
            out, ref = out[0], ref[0]
        mae, rel = rel_err(out, ref)
        ok = rel <= tol and bool(torch.isfinite(out.float()).all())
        launch = launcher()[0]
        ms = time_ms(launch)
        wrapper_ms = time_ms(wrapper)
        plain_ms = time_ms(plain, iters=plain_iters, warmup=1)
        library_ms = None if library is None else time_ms(library)
        t_bytes, t_ops = b_bytes / HBM_BYTES_PER_S, ops / peak
        bound = max(t_bytes, t_ops) * 1e3
        row = dict(name=name, shape=label, max_abs_err=mae, rel_err=rel,
                   tol=tol, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                   bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms, bytes=b_bytes, ops=ops, ok=ok)
        rows.append(row)
        log(f"kernel {name} [{label}] rel_err={rel:.3e} (tol {tol}) "
            f"ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound:.4f} library_ms={library_ms}")
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees: {rel}")
        if main:
            entries[name] = row

    # activation prep of every W4A8 call (plain XLA in the JAX package)
    from ktransformers_tpu_torch.quant.w4a8 import w4a8_prep

    def split(outs):
        """(codes and scales, sums t), each flattened to float."""
        return (torch.cat([v.float().flatten() for v in outs[:4]]),
                outs[4].flatten())

    # held to the plain version on the CPU (PyTorch's CUDA division by a
    # scalar multiplies by the reciprocal, so the card's plain version can
    # put a code one step off): codes and scales bit-exact, the sums t to
    # float32 rounding
    for m, label, main in ((1, "decode M=1 K=2048", True),
                           (256, "prefill M=256 K=2048", False)):
        x = rn(m, 2048)
        check("w4a8_prep", label, 0.0,
              lambda: split(MM.prep_activations(x, 2048, 128)),
              lambda: split(w4a8_prep(x, 2048, 128)[:5]),
              lambda: (lambda: MM.prep_activations(x, 2048, 128), None),
              nbytes(x) + m * 2048 + 3 * m * 16 * 4, 0, INT8_OPS_PER_S,
              main=main, side_tol=1e-5,
              expect=lambda: tuple(v.to(dev) for v in split(
                  w4a8_prep(x.cpu(), 2048, 128)[:5])))

    # row 1: dense_w4a8_matmul
    for m, k, n, label, main in (
        (1, 2048, 3648, "decode qkv_a M=1", True),
        (1, 2048, 2048, "decode o_proj M=1", False),
        (1, 2048, 102400, "decode lm_head M=1", False),
        (1, 2048, 21888, "decode layer-0 gate_up M=1", False),
        (1, 10944, 2048, "decode layer-0 down M=1 (gs 96)", False),
        (256, 2048, 3648, "prefill qkv_a M=256", False),
    ):
        wt, x = w((k, n)), rn(m, k)
        wdq = dequantize(wt, bf)
        check("dense_w4a8_matmul", label, 1e-2,
              lambda: MM.dense_w4a8_matmul(x, wt),
              lambda: MM.w4a8_matmul_ref(x, wt),
              lambda: MM.dense_w4a8_launcher(x, wt),
              nbytes(x, wt.data, wt.scales) + m * n * 2, 2 * m * n * k,
              INT8_OPS_PER_S, library=lambda: torch.matmul(x, wdq),
              main=main)
        del wdq, wt

    e, d, f = 64, 2048, 1408
    gu, dn = w((e, d, 2 * f)), w((e, f, d))
    per_expert = nbytes(gu.data[0], gu.scales[0], dn.data[0], dn.scales[0])

    # row 2: gathered_w4a8_ffn (decode: 6 routed rows, distinct experts)
    ids = torch.randperm(e, generator=torch.Generator().manual_seed(0))[:6]
    ids = ids.to(torch.int32).to(dev)
    x = rn(6, d)
    check("gathered_w4a8_ffn", "decode 6 rows, 2048->2x1408->2048", 3e-2,
          lambda: F.gathered_w4a8_ffn(x, gu, dn, ids),
          lambda: F.gathered_w4a8_ffn_ref(x, gu, dn, ids),
          lambda: F.gathered_launcher(x, gu, dn, ids),
          6 * per_expert + 2 * nbytes(x), 2 * 6 * 3 * d * f,
          INT8_OPS_PER_S, main=True)

    # row 4: grouped_w4a8_ffn (prefill: 256 tokens x top-6 sorted rows)
    g_cpu = torch.Generator().manual_seed(1)
    topk = torch.stack([torch.randperm(e, generator=g_cpu)[:6]
                        for _ in range(256)]).to(dev)
    sizes = torch.bincount(topk.reshape(-1), minlength=e).to(torch.int32)
    xs = rn(1536, d)
    used = int((sizes > 0).sum())
    check("grouped_w4a8_ffn", "prefill 1536 rows (256 tok x 6), 64 experts",
          3e-2,
          lambda: F.grouped_w4a8_ffn(xs, gu, dn, sizes),
          lambda: F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes),
          lambda: F.grouped_launcher(xs, gu, dn, sizes),
          used * per_expert + 2 * nbytes(xs), 2 * 1536 * 3 * d * f,
          INT8_OPS_PER_S, main=True, plain_iters=2)
    del gu, dn

    # row 3: dense_w4a8_ffn (the shared experts, 2 x 1408; the layer-0
    # MLP takes two dense_w4a8_matmul calls, as in the JAX package)
    for m, inter, label, main in (
        (1, 2816, "decode shared M=1 I=2816", True),
        (256, 2816, "prefill shared M=256", False),
    ):
        sgu, sdn, x = w((d, 2 * inter)), w((inter, d)), rn(m, d)
        check("dense_w4a8_ffn", label, 3e-2,
              lambda: F.dense_w4a8_ffn(x, sgu, sdn),
              lambda: F.dense_w4a8_ffn_ref(x, sgu, sdn),
              lambda: F.dense_launcher(x, sgu, sdn),
              nbytes(sgu.data, sgu.scales, sdn.data, sdn.scales)
              + 2 * nbytes(x), 2 * m * 3 * d * inter, INT8_OPS_PER_S,
              main=main)
        del sgu, sdn

    # row 5: mla_decode_fused (16 heads, R 512, dr 64, 512 cached tokens)
    b, h, r, dr, smax, length = 1, 16, 512, 64, 1024, 512
    cos, sin = precompute_rope_tables(RopeConfig(dim=dr, max_position=2048,
                                                 interleaved=True), dev)
    rot = rope_rotation_matrix(cos[length][None], sin[length][None], True)
    qn, qp, kv = rn(b, h, r), rn(b, h, dr), rn(b, 1, r + dr)
    gamma = torch.ones(r, device=dev)
    ckv, kpe = rn(b, smax, r), rn(b, smax, dr)
    lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
    args = (qn, qp, kv, gamma, rot, ckv, kpe, lengths, (128 + 64) ** -0.5,
            1e-6)
    check("mla_decode_fused", f"decode H=16 cached={length}", 1e-2,
          lambda: MD.mla_decode_fused(*args),
          lambda: MD.mla_decode_fused_ref(*args),
          lambda: MD.mla_launcher(*args),
          length * (r + dr) * 2 + nbytes(qn, qp, kv) + b * h * r * 2,
          2 * h * (length + 1) * (2 * r + dr), BF16_FLOPS_PER_S, main=True)


# ----------------------------------------------------------------- parity


def parity_check(result: dict) -> None:
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.model import KVCache, forward
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    cfg = dict(bench_model_cfg(), num_hidden_layers=2)
    spec = spec_from_hf_config(cfg)

    def run(device):
        params = prepare_params(init_params_synthetic(spec, seed=5,
                                                      device="cpu"), spec)
        params = _to(params, device)
        cache = KVCache.create(spec, 1, 128, torch.float32, device)
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg["vocab_size"], (1, 64)), device=device)
        logits, cache = forward(params, spec, toks, cache,
                                compute_dtype=torch.float32,
                                logits_last_only=True)
        outs = [logits[:, -1].float().cpu()]
        for step in range(4):
            tok = torch.tensor([[FEED[step]]], device=device)
            logits, cache = forward(params, spec, tok, cache,
                                    compute_dtype=torch.float32)
            outs.append(logits[:, -1].float().cpu())
        return outs

    FEED = [11, 2222, 33333, 44444]  # fixed tokens, the same on both sides
    t0 = time.perf_counter()
    cpu = run("cpu")
    gpu = run("cuda")
    errs = [rel_err(g, c)[1] for g, c in zip(gpu, cpu)]
    agree = sum(int(g.argmax()) == int(c.argmax()) for g, c in zip(gpu, cpu))
    finite = all(bool(torch.isfinite(g).all()) for g in gpu)
    result["parity"] = dict(rel_err=errs, greedy_agree=agree, steps=len(cpu),
                            seconds=time.perf_counter() - t0)
    log(f"parity: logits rel_err per step {['%.3e' % e for e in errs]}, "
        f"greedy agree {agree}/{len(cpu)}")
    # float32 compute on both sides (in bf16 the two devices round the
    # router input differently and near-tied experts swap). What remains is
    # float32 summation order, which now and then flips an int8 activation
    # code; tests/test_torch_model.py bounds that noise at 5e-2.
    if not finite or max(errs) > 5e-2:
        raise AssertionError(f"parity failed: {errs} finite={finite}")


def _to(node, device):
    import dataclasses

    from ktransformers_tpu_torch.quant.formats import QTensor

    if isinstance(node, QTensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _to(getattr(node, f.name), device)
            for f in dataclasses.fields(node)})
    return node


# ------------------------------------------------------------------ serve


def serve(result: dict) -> None:
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    cfg = bench_model_cfg()
    spec = spec_from_hf_config(cfg)
    t0 = time.perf_counter()
    params = init_params_synthetic(spec, seed=0, quant="int4_g",
                                   moe_quant="int4_g", device="cuda")
    gen = Generator(params, spec, max_len=1024, batch=1, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = 0
    for obj in _leaves(gen.params):
        pbytes += obj.numel() * obj.element_size()
    log(f"serve: params {pbytes / 1e9:.3f} GB ready in {init_s:.1f} s")

    # warm-up request (allocator, cuBLAS handles); not counted
    gen.generate(list(range(8)), GenerateConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs = []
    for i in range(3):
        prompt = np.random.default_rng(100 + i).integers(
            0, cfg["vocab_size"], 512).tolist()
        stamps = []

        def on_token(tok, stamps=stamps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t_start = time.perf_counter()
        out = gen.generate(prompt, GenerateConfig(max_new_tokens=32),
                           on_token=on_token)
        toks = out[0]
        if len(toks) != 32 or not all(0 <= t < cfg["vocab_size"]
                                      for t in toks):
            raise AssertionError(f"request {i}: bad tokens {toks}")
        ttft = stamps[0] - t_start
        dec = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        reqs.append(dict(prefill_tok_s=512 / ttft, ttft_s=ttft,
                         decode_tok_s=dec, tokens=toks[:8]))
        log(f"serve request {i}: prefill {512 / ttft:.1f} tok/s "
            f"(ttft {ttft * 1e3:.1f} ms), decode {dec:.2f} tok/s")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    result["serve"] = dict(requests=reqs, launches=launches,
                           max_memory_allocated=peak, params_bytes=pbytes,
                           init_s=init_s)
    log(f"serve: max_memory_allocated {peak / 1e9:.3f} GB, launches "
        f"{json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the serve run: {missing}")
    return gen


# ---------------------------------------------------------------- profile


def _is_port_kernel(name: str) -> bool:
    return any(k in name for k in ("w4a8_rows_kernel", "ffn_up_kernel",
                                   "w4a8_prep_kernel",
                                   "mla_decode_fused_kernel"))


def profile_steps(result: dict, gen) -> None:
    """Where the time of a 256-token prefill chunk (the second of a
    512-token prompt) and of a decode step over those 512 tokens goes.
    Wall time: median of 3 unprofiled chunks (each on a fresh cache), mean
    of 8 unprofiled decode steps. Launches: per chunk and per step. Device
    time by kernel: torch.profiler over one more chunk and one more step
    (kernel events only, so PyTorch ops are not counted twice). Runs after
    the serve counts were read, so it adds nothing to them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    prompt = torch.as_tensor(np.random.default_rng(200).integers(
        0, gen.spec.vocab_size, (1, 512)), device=gen.device)
    first, second = prompt[:, :256], prompt[:, 256:]

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def kernel_rows(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        return sorted(rows, key=lambda r: -r[1])

    def primed(chunks: int):
        cache = gen.new_cache()
        last = None
        for c in (first, second)[:chunks]:
            last, cache = gen.prefill(cache, c)
        return cache, last.argmax(-1)

    steps = {}
    # prefill chunk
    walls = []
    for _ in range(3):
        cache, _ = primed(1)
        reset_launches()
        walls.append(wall_ms(lambda: gen.prefill(cache, second)))
    chunk_launches = dict(LAUNCHES)
    cache, _ = primed(1)
    steps["prefill_chunk"] = (statistics.median(walls), chunk_launches,
                              kernel_rows(lambda: gen.prefill(cache, second)))
    # decode step
    cache, tok = primed(2)
    state = {"tok": tok}

    def step():
        state["tok"], _ = gen.decode_step(state["tok"], cache)

    reset_launches()
    step()
    step_launches = dict(LAUNCHES)
    wall = wall_ms(lambda: [step() for _ in range(8)]) / 8
    steps["decode_step"] = (wall, step_launches, kernel_rows(step))

    out = {}
    for name, (wall, launches, rows) in steps.items():
        busy = sum(r[1] for r in rows)
        ours = sum(r[1] for r in rows if _is_port_kernel(r[0]))
        kernels = sum(r[2] for r in rows)
        out[name] = dict(
            wall_ms=wall, device_busy_ms=busy, port_kernels_ms=ours,
            device_kernels=kernels,
            idle_share=1.0 - busy / wall if busy else None,
            launches=launches,
            top=[dict(name=k[:90], ms=ms, count=n) for k, ms, n in rows[:12]],
        )
        log(f"profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"in {kernels} kernels (port kernels {ours:.3f} ms), "
            f"launches {json.dumps(launches)}")
        for k, ms, n in rows[:12]:
            log(f"  {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    result["profile"] = out


def _leaves(node):
    import dataclasses

    from ktransformers_tpu_torch.quant.formats import QTensor

    if isinstance(node, QTensor):
        yield from (t for t in (node.data, node.scales) if t is not None)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    elif isinstance(node, torch.Tensor):
        yield node
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _leaves(getattr(node, f.name))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ktransformers_tpu_torch.ops.cuda import KERNELS, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    result: dict = {}
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    result["card"] = card

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(logs)} sources in {build_s:.1f} s")
    result["build_s"] = build_s
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
        for name, text in logs.items():
            fh.write(f"== {name}\n{text}\n")

    rows: list = []
    entries: dict = {}
    kernel_checks(rows, entries)
    result["kernel_rows"] = rows
    torch.cuda.empty_cache()

    parity_check(result)
    torch.cuda.empty_cache()

    gen = serve(result)
    profile_steps(result, gen)
    del gen

    sources = {
        # plain XLA in the JAX package, no Pallas kernel
        "w4a8_prep": ("ktransformers_tpu_torch/csrc/w4a8_matmul.cu",
                      "ktransformers_tpu/quant/w4a8.py:92"),
        "dense_w4a8_matmul": ("ktransformers_tpu_torch/csrc/w4a8_matmul.cu",
                              "ktransformers_tpu/ops/pallas/w4a8_matmul.py:930"),
        "gathered_w4a8_ffn": ("ktransformers_tpu_torch/csrc/w4a8_ffn.cu",
                              "ktransformers_tpu/ops/pallas/w4a8_matmul.py:308"),
        "dense_w4a8_ffn": ("ktransformers_tpu_torch/csrc/w4a8_ffn.cu",
                           "ktransformers_tpu/ops/pallas/w4a8_matmul.py:484"),
        "grouped_w4a8_ffn": ("ktransformers_tpu_torch/csrc/w4a8_ffn.cu",
                             "ktransformers_tpu/ops/pallas/w4a8_matmul.py:818"),
        "mla_decode_fused": ("ktransformers_tpu_torch/csrc/mla_decode.cu",
                             "ktransformers_tpu/ops/pallas/mla_decode.py:199"),
    }
    kernels = []
    for name in KERNELS:
        row = entries[name]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1],
            launches=result["serve"]["launches"][name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            wrapper_ms=row["wrapper_ms"],
            shape=row["shape"],
        ))
    result["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
