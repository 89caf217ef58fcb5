"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
1. card:    nvidia-smi name and power limit;
2. build:   nvcc builds every kernel source in ktransformers_tpu_torch/csrc
            (one nvcc per source, all started together);
3. kernels: the first twelve kernels against their plain PyTorch versions
            on the card at the DeepSeek-V2-Lite shapes of the main paths
            (single user: M = 1 and 256-token chunks; paged serving: a
            decode batch of 8, mixed steps of 8 + C*S rows, page tables;
            the SFT step's M = 512), with times; the quant_matmul family
            once per weight format (int8, fp8, int4, int4_g, int4_gz,
            mxfp4, mxfp8). Where a wrapper routes a call to a redesigned
            kernel (quant_mma_kernel, w4a8_mma_kernel: 2 rows or more;
            quant_gemv_kernel, w4a8_gemv_kernel: one-row dense calls, every
            gathered call and the W4A8 FFN's one-row down;
            w4a8_ffn_mma_kernel: the W4A8 FFN's gate_up from 2 rows on;
            w4a8_ffn_gemv_kernel: its one-row gate_up, whose half of the
            call is timed apart too, beside the first version's and its
            bound;
            quant_wgmma_t_kernel: the transposed matmuls;
            mla_decode_split_kernel: bf16 mla_decode_fused, timed at 512,
            2048 and 4095 cached rows, and without its current-token
            block (mla_decode_split_kernel<false>) bf16
            mla_decode_attention; mla_prefill_mma_kernel: bf16
            mla_paged_prefill; mla_paged_decode_split_kernel: bf16
            mla_paged_decode; gqa_prefill_mma_kernel and
            gqa_decode_split_kernel: bf16 gqa_paged_prefill and
            gqa_paged_decode, phase 9; the attention caches and pools
            hold NaN in every row the kernels must not read), the first
            version is held and timed on the same operands too (first_ms)
            and a second call of the wrapper must give the same bits; the
            grouped entries get torch._grouped_mm as their library
            yardstick where this PyTorch has it; every W4A8 call of rows
            1-4, 7 and 8 runs its kernel folded (quantizing x itself)
            and unfolded on the codes of a prep launch, which must give
            the same bits, and times the folded kernel beside prep +
            unfolded kernel; then the same W4A8 rows (1-4, 7, 8 and the
            prep) on int4_gz at group 32 and 16 and per-channel int4
            (zero_point_kernel_checks: the zero term, groups 32 / 16 on
            the tensor cores, a per-channel down group on the FFN's split
            route) at M = 1, 8, 256, 264;
4. parity:  the full-width config cut to 2 layers, the same synthetic
            weights on the CPU (plain versions) and on the card (kernels),
            float32 compute: a 64-token prefill and 2 decode steps through
            forward(); the same through forward_paged (two chunks, page
            tables), and forward_paged_mixed against separate decode and
            prefill calls on the card. Twice: with unquantized float32
            weights (two dense layers), every logits row within 1e-4 of its
            largest logit and the KV pools within 2e-5; with W4A8 weights
            (one dense, one MoE layer), greedy tokens equal except at a
            near-tie; then the same dense + MoE model once per weight
            format through the quant_matmul kernels (no activation requant:
            every logits row within FORMAT_TOL), int8 also through the
            paged forward and with the fused decode switched off
            (mla_decode_attention); and a greedy Generator run with
            repetition / presence / frequency penalties on 2 narrow
            layers, card tokens equal to the CPU's (penalty_check);
5. serve:   the full 27-layer config (int4_g weights) in a Generator at
            max_len 1024 answering 2 requests of 512 seeded prompt tokens
            and 32 greedy new tokens through its prefill chunks and decode
            step captured in CUDA graphs (engine/cuda_graph.py; a
            768-token warm-up captures the 256-token chunk's step) and the
            depth-24 pipelined readback, each request's tokens equal to
            the eager prefill and decode_step loop's (every model phase
            serving a Generator holds this); every single-user kernel must
            launch; then every
            scratch set is replaced by one twice its size after the
            capture and a replay must still give the eager tokens, and a
            sampled run repeats token for token under one seed;
6. paged serve: a ServeEngine over the same parameters (batch 8, chunk 256,
            page 64, 512 pages; its prefill, decode and mixed steps
            captured and replayed)
            answering 8 requests in three waves, 32 greedy tokens each, at
            decode pipeline depth 3; mixed steps, a 256-token prefix hit,
            page accounting and agreement with the single-user Generator
            are checked (and that the prompts give at least 4 distinct
            first tokens, without which that agreement would not see the
            prompt); the same run with every step eager gives the same
            tokens, a mixed step having been captured;
7. profile: a prefill chunk and a decode step of the Generator, a batch-8
            decode step and a mixed step of the ServeEngine (a hybrid
            model's split step), each eager and replayed from its graph
            (each port kernel as often in the captured graph's nodes as
            in the eager step's trace, every kernel at least as often in
            the replay's trace), and the graph pools' bytes: wall time, launches per step (equal for
            the two), device time by kernel (torch.profiler); a
            step that still launches a first-version instantiation its
            routes replace (8-row tiles on bf16, one-row quant_matmul
            tiles, any W4A8 rows kernel, the FFN's gate_up of 1 and 4 rows
            a tile, the transposed first version, the bf16 MLA fused
            decode, decode attention, paged decode and paged prefill and
            the bf16 GQA paged decode, its combine launch and paged
            prefill first versions) fails (so does the SFT step's
            profile); the activation preps of the decode step (none) and
            of the batch-8 step (those the fold crossovers imply) are
            held;
7b. front door: the port's OpenAIServer (serving/server.py, IdTokenizer)
            over a ServeEngine on phase 6's parameters at a free loopback
            port: phase 6's 8 prompts from 8 client threads at once
            (token-id /v1/completions, two of them streamed, one through
            /api/generate) and a chat completion, each request's tokens
            held to the single-user Generator's by phase 6's rule,
            client-side TTFT / TBT / latency and the output tok/s, the
            launches of the run (path http_serve: rows 1-4, 12 and 14
            required; http_serve); then the CLI (front_door_cli):
            DeepSeek-V2-Lite's full width at 2 layers as HF-named bf16
            tensors in a two-shard safetensors directory, `python -m
            ktransformers_tpu_torch.cli convert` (SafetensorsProvider ->
            build_params, int8 with int4_g experts) to a packed directory,
            `doctor`, `serve <packed>` as a process answering two greedy
            requests whose tokens equal an in-process ServeEngine's over
            load_params(<packed>); the packed tree on the card equal to
            the CPU's bits, its logits card vs CPU by moe_parity;
7c. speculation (speculation_run, before 7b): on phase 5's parameters a
            512-token prompt and 32 new tokens at k = 3 through
            speculative_generate (the target as its own draft),
            draft_generate (a drawn 2-layer drafter of the same widths),
            mtp_generate and mtp_generate_fused (an init_mtp_synthetic
            head, a MoE layer): rounds, acceptance, output tok/s (prefill
            included) beside the plain Generator's, launches; tokens held
            to the single-user ones by phase 6's near-tie rule; a cache of
            prompt + 32 refused before any step; on 2 full-width layers
            of float32 weights all five functions token for token equal to
            Generator.generate; the verify step's shapes (M = 4 / 5 on rows
            1 and 3, (k + 1) x 6 gathered rows on row 2) against their
            plain versions with bound and library times;
7d. sparse serve (sparse_serve_run): on phase 5's parameters the
            ServeEngine with a budget of the whole page table against the
            dense one (4 requests, both held to the single-user tokens by
            phase 6's rule, no paged decode kernel launched); 4 prompts of
            2,048 tokens + 32 at a budget of 8 of 32 pages (quest / layer)
            against the dense engine: output tok/s, mean TBT; the card's
            sparse decode against the CPU's on that run's pools with NaN in
            every dead row; at 2 layers the other anchors and retrievals
            (full budget held, budget 2 run) and offload x sparse against
            the offloaded dense engine;
8. int8:    the int4_g parameters are freed; the config cut to INT8_LAYERS
            = 9 of its 27 layers with
            int8 weights (every matmul through the quant_matmul kernels) in
            a Generator answering 2 requests of 512 + 32 tokens, the second
            with the fused decode off; launches per decode step and per
            prefill chunk held to the counts the code implies (with the
            fused decode off, every attention call on
            mla_decode_split_kernel<false>); a
            ServeEngine over the same parameters answering the 8 requests
            of phase 6 at pipeline depth 3 with the same checks; the
            profiles of phase 7 on the int8 parameters;
9. mixtral: the int8 parameters are freed; the kernels of the
            Mixtral-8x7B path (its int8 qkv / o_proj / lm_head at M = 1,
            gathered / grouped W4A8 matmul, GQA paged decode / prefill)
            against their plain versions at its shapes;
            parity of its full width cut to 2 layers with the served kinds
            (int8 attention, int4_g W4A8 experts), held by moe_parity (the
            W4A8 variant's rule of phase 4, and a row past NEAR_TIE only
            where a route it sees differs between the devices); then
            MIXTRAL_LAYERS = 8 of its 32 layers in a Generator answering 2
            requests of 512 + 32 tokens, launches per step held to the
            counts the code implies, a ServeEngine answering the 8 requests
            of phase 6 at depth 3 with the same checks, and the profiles of
            phase 7 (engine launches per step held too);
10. sft kernels: the two transposed matmuls of the LoRA SFT backward
            (rows 16 and 17) against their plain versions at the
            DeepSeek-V2-Lite shapes of a 512-token step (every projection's
            dx; every weight format at the qkv_a shape; N = 1824; the
            grouped experts and the gathered entry);
11. sft parity: the 2-layer full-width model, one Trainer step on the
            card and on the CPU (float32 compute): int8 weights held (loss,
            every LoRA gradient, the updated leaves), W4A8 weights recorded;
12. sft:    the 27-layer W4A8 model with rank-8 adapters, as
            scripts/bench_sft.py sets it up (seq 512, batch 1, bf16,
            per-layer remat): a first step and 4 timed steps through
            Trainer.train_step, finite losses, a frozen base, adapters that
            moved, launches per step held to the counts the code implies,
            peak memory, and one profiled step;
13. v3 kernels: DeepSeek-V3's widths (hidden 7168, 128 MLA heads, 256
            experts top-8, q_lora 1536; v3_cfg): row 1 at M = 1, 8, 256
            and 264 (qkv_a 7168 -> 2112, q_b 1536 -> 24576, o_proj 16384
            -> 7168, lm_head 7168 -> 129280), row 3 at the same M (shared
            expert I = 2048, dense MLP I = 18432), rows 7-8 (the routed experts, which the fused
            FFN's budget refuses: 8 and 64 gathered rows, 4096 grouped rows
            over 256 experts), row 5 at H = 128 with V3's softmax scale,
            rows 12 and 14 at H = 128; each against its plain version, as
            phase 3;
14. v3 parity: DeepSeek-V3 at full width cut to 2 layers (one dense, one
            MoE), W4A8, an 8-token prompt and 2 decode steps card vs CPU
            (moe_parity); DeepSeek-V2-Lite's 2-layer model with
            unquantized float32 experts (the plain expert products of
            ops/moe.py on both devices), held to PARITY_TOL;
15. v3 serve: DeepSeek-V3 cut to 6 layers (3 dense, 3 MoE; W4A8, bf16
            absorbed mats): a Generator answering 2 requests of 512 + 32
            tokens, a ServeEngine answering the 8 requests of phase 6 at
            depth 3 (near-tie V3_NEAR_TIE), the four profiled steps,
            launches per step held to V3_STEP_LAUNCHES /
            V3_ENGINE_STEP_LAUNCHES; then the same 6 layers with int8
            weights: one Generator request and the ServeEngine's 8 held
            to the Generator at NEAR_TIE;
16. gguf:   DeepSeek-V2-Lite's published shape cut to 3 layers written as a
            GGUF file (Q4_K matmuls and lm_head, Q4_1 where the input
            width is no multiple of 256, one layer's experts' down in
            Q8_0, F16 embedding; ~1.4 GB in a temporary directory) with
            the port's write_gguf, read back by spec_from_gguf_fields and
            GGUFProvider + build_params(exact_gguf=True), a sample
            dequantized against decode_ggml, prepared for W4A8 (every W4A8
            weight int4_gz), parity card vs CPU by moe_parity, then
            one request of 256 + 32 tokens, the ServeEngine's 8 requests
            at depth 3 and the four profiled steps; every W4A8 call on a
            redesigned kernel (gguf_serve);
17. qwen:   the kernels of the Qwen paths at their widths against their
            plain versions (qwen_kernel_checks: row 9 on every int8 weight
            of the served kinds at M = 1, 8 and 256 (the fused QKV with
            Qwen2's bias, o_proj, Qwen2's 20480-wide shared expert) and on
            the 151,936-wide lm_head, Qwen3's experts on the fused FFN,
            rows 2 and 4, Qwen2's on rows 7 and 8, row 3 on Qwen2's shared
            expert as all-int4_g weights would have it, rows 13 and 15 at
            G = 8 and G = 7); 2-layer parity card vs CPU of both models
            with the served kinds (int8 attention, shared expert and
            lm_head, int4_g experts) by moe_parity; then Qwen3-30B-A3B cut
            to QWEN3_LAYERS = 8 of its 48 layers and Qwen2-57B-A14B cut to
            4 layers (depth only, full width), each in a Generator answering
            2 requests of 512 + 32 tokens and a ServeEngine answering the 8
            requests of phase 6 at depth 3, profiled, launches per step held
            to QWEN3_* / QWEN2_* (qwen_run);
18. long context: DeepSeek-V2-Lite and Llama-3.1-8B at full width cut to
            2 layers, int8 weights, in a Generator at max_len 16,384: a
            seeded 9,000-token prompt prefilled in 256-token chunks and 8
            greedy tokens, once on the blockwise path (the cache buffer past
            BLOCKWISE_KV_THRESHOLD: mla_absorbed_blockwise at the MLA
            prefill, mha_blockwise at every GQA step, their calls counted)
            and once with the threshold above max_len (the dense path), on
            the same weights: the last chunk's logits within LONG_TOL of the
            dense path's, tokens equal up to a near-tie, the peak memory and
            time of the last full chunk recorded (long_context);
19. dense and GLM: the kernels of the Llama-3.1-8B and GLM-4.5-Air paths
            at their widths (dense_glm_kernel_checks: row 9 on every int8
            weight at M = 1, 8, 256, GLM's experts on rows 7 and 8, row 3 on
            GLM's shared expert and dense MLP as int4_g weights, rows 13 and
            15 at G = 12); 2-layer parity card vs CPU (Llama int8 held to
            FORMAT_TOL, GLM by moe_parity); then Llama-3.1-8B cut to
            LLAMA_LAYERS = 8 of its 32 layers (int8) and GLM-4.5-Air cut
            to GLM_LAYERS = 4 (the dense
            layer and 3 MoE layers; int8 with int4_g experts, the published
            q / k / v biases), each in a Generator answering 2 requests of
            512 + 32 tokens and a ServeEngine answering the 8 requests of
            phase 6 at depth 3, profiled, launches per step held to
            LLAMA_* / GLM_* (dense_glm_run);
20. hybrid and window: rows 13 and 15 at head dim 256 (Qwen3-Next's 16
            query heads over 2 KV heads: decode B = 1 and 8 at 512 and 4,608
            keys, a 256-token chunk after 256; bf16 and float32) and at
            SmallThinker's G = 7 past its 4,096-key window (decode at 4,097
            to 8,200 keys, chunks after 4,352 and 7,944; the keys before
            each window NaN), library SDPA on a gathered copy; parity card
            vs CPU of SmallThinker-21B at 2 layers and Qwen3-Next-80B-A3B at
            4 (3 GatedDeltaNet + 1 gated full attention) with the served
            kinds by moe_parity; on float32 weights at 4 layers (one NoPE
            layer) a ServeEngine against the single-user Generator token for
            token up to a float32 near-tie, a 4,608-token prompt past the
            window included; then SmallThinker cut to SMALLTHINKER_LAYERS
            answering a 4,608-token and a 512-token request single-user and
            the 8 requests of phase 6 with request 0 the 4,608-token prompt
            through the ServeEngine (its random weights grow any rounding
            difference, so a request may leave the single-user tokens only
            at a near-tie or after a reroute, and the engine's model step
            with the single-user routes forced on it stays within twice
            what bf16 rounding moves the single-user step, up to there and
            over request 0: reroute_check), and
            Qwen3-Next
            cut to QNEXT_LAYERS single-user and through the ServeEngine at
            batch 8 (no prefix cache, no fused mixed step, request 4 on
            request 0's reused slot, its state zeroed); profiled, launches
            per step held to SMALLTHINKER_* / QNEXT_*, the GatedDeltaNet
            recurrence's share of Qwen3-Next's prefill chunk recorded
            (hybrid_window_run);
21. offload: DeepSeek-V2-Lite, all 27 layers at full width, int4_g,
            its routed experts in host memory (offload_run): one layer's
            host FFN (the C++ of csrc/host_moe.cpp, built with g++) at 1, 8
            and 256 rows against the plain float32 product on the card;
            the HostOffloadGenerator on 2 requests of 256 + 16 tokens at
            batch 2, and with 2 microbatches (the same tokens as the
            requests alone); a HostOffloadServeEngine answering 4 requests
            (one sharing 128 tokens of another's prompt), held to the
            single-user tokens by phase 6's rule; launches per step held to
            OFFLOAD_STEP_LAUNCHES; one decode step profiled (host ms a
            hop, busy, idle, the shared experts' device time inside the
            hops); one request's logits with float32 hops against the
            resident Generator on the same weights with KT_W4A8=0, under
            the offloaded run's routes, within SPREAD_FACTOR times the
            bf16 rounding spread (offload_vs_resident); streamed experts
            (offload_moe_weights) bit-identical to that Generator over 8
            decode steps, and a 256-token chunk within the same bound
            (streamed_check); 2-layer parity card vs CPU; the host's cores,
            RAM and threads;
22. parallel: DeepSeek-V2-Lite at full width cut to PARALLEL_LAYERS = 4
            (parallel_run): the W4A8 Generator with its shared experts
            fused into the routed set against the unfused one (256 + 16
            tokens held by phase 6's rule, 2-layer-style parity rows by
            moe_parity's rule, dense_w4a8_ffn gone from the MoE layers, a
            decode step of each timed in turns and profiled); a ServeEngine
            with collect_routing on 4 requests, apply_expert_rebalance(2),
            the 4 again, both waves held to the single-user tokens and the
            second equal to the first; rows 5,
            12 and 14 at a TP rank's 8 heads (the queries followed by NaN
            rows); then PARALLEL_RANKS = 2 spawned ranks sharing the card
            over gloo (no interconnect measured): EP = 2 on W4A8 (a 256-token
            chunk through the all-to-all, decode through the all-reduce;
            contiguous and paged) and TP = 2 on int8, each rank's rows held
            to the single device's by moe_parity's rule (TP's also under the
            single device's routes, every row within SPREAD_FACTOR times
            the bf16 rounding spread), its launches, step
            times and collectives by path printed; then, on the same
            ranks, the training half: PP = 2 on Mixtral-8x7B at full
            width cut to PP_LAYERS = 4 (2 a stage, PP_MICROBATCHES = 4 of
            1 x 128 tokens; W4A8 logits held to the one-device forward by
            hold_pipelined, then int8 float32 LoRA loss and stage
            gradients by hold_sft, sft_parity's tolerances), ZeRO-1 at
            dp = 2 (2 steps in lockstep with a one-device Trainer, the
            moments cut in half) and one EP = 2 attention-LoRA step (psum
            and a2a) on the 4-layer int8 DeepSeek-V2-Lite, each held to
            one device by hold_sft, its launches held to PP_KERNELS /
            PARALLEL_SFT_KERNELS (rows 16 and 17 in every backward); a
            rank that fails or hangs (PARALLEL_JOIN_S) fails the phase.
The parity phases draw their 2-layer weights on the card and copy them to
the host (card_drawn), where the host took 7-9 s to draw each.
Each phase's seconds are logged and kept in chip_smoke.json (phase_s).
Prints a kernels JSON line (the eighteen wrappers, then the thirteen
redesigned kernels, whose launches are those of their wrappers' calls
that took them; the MLA kernels must have launched on the single-user
(decode) and paged (paged decode and prefill) paths of both DeepSeek
parameter sets, mla_decode_split_kernel<false> on the int8 single-user
path (its last request decodes with the fused decode off), the FFN's
one-row gate_up on both W4A8 decode paths and Qwen3's, the GQA kernels on
Mixtral's, both Qwen models', Llama's, GLM's, SmallThinker's and
Qwen3-Next's paged paths, the fused FFN's kernels on both of the last two
models' paths, the MLA
kernels and both W4A8 matmul kernels on DeepSeek-V3's two paths and the W4A8
matmul kernels on Qwen2's and GLM's, row 9 and both its redesigned kernels
on Llama's; rows 1-5 and their redesigned kernels on the speculation
paths, row 6 on the MTP paths, rows 1-4 and 14 on the sparse serving
paths; w4a8_ffn_gemv_kernel's entry gives the gate_up half's times
and bound; a W4A8 entry also its "fold": the folded kernel beside prep +
unfolded kernel), the card line, and as
the last line
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
OUT_DIR = "chiprun_out"
ROOT = os.path.dirname(os.path.abspath(__file__))


_T0 = time.perf_counter()


def log(*a):
    """A line of the run's log, after the seconds since the script
    started; also appended to chiprun_out/chip_smoke.log (a captured
    output may keep only its end)."""
    line = " ".join([f"[{time.perf_counter() - _T0:7.1f}]", *map(str, a)])
    print(line, flush=True)
    if os.path.isdir(OUT_DIR):
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as fh:
            fh.write(line + "\n")


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


def rel_err(out: torch.Tensor, ref: torch.Tensor,
            per_row: bool = False) -> tuple[float, float]:
    """(largest absolute error, error relative to ref's largest magnitude);
    with per_row, the relative error is taken per row of the last dimension
    (each against its own row's largest magnitude) and the worst row given."""
    if per_row:
        d = (out.float() - ref.float()).abs().flatten(0, -2).amax(-1)
        top = ref.float().abs().flatten(0, -2).amax(-1).clamp_min(1e-30)
        return d.max().item(), (d / top).max().item()
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bench_model_cfg():
    from ktransformers_tpu_torch.models.spec import DEEPSEEK_V2_LITE

    return dict(DEEPSEEK_V2_LITE)


# ---------------------------------------------------------------- kernels


def make_check(rows: list, entries: dict):
    """check(): one kernel through its public wrapper against its plain
    version on the same inputs. ms times the kernel launch alone on
    prepared operands (the wrapper's launcher); wrapper_ms times the whole
    wrapper call (activation prep, tile maps, allocation, host work
    included)."""

    def check(name, label, tol, wrapper, plain, launcher, b_bytes, ops,
              peak, library=None, main=False, side_tol=None,
              expect=None, iters=20, per_row=False, first=None, kernel=None,
              kernel_main=False, up=None, fold=None):
        """expect (default plain) gives what the wrapper is held to; plain
        is what plain_ms times on the card; per_row holds every row of the
        output's last dimension to tol of its own largest value. Where the
        wrapper routes the call to a tensor-core kernel, ``kernel`` names
        it and ``first`` gives the first version's launcher on the same
        operands: first_ms times it, and it is held to the plain version
        too. A row with main=True is its wrapper's entry of the kernels
        line, one with kernel_main=True its redesigned kernel's. An FFN
        call's ``up`` (dict of its gate_up half's plain version, bytes,
        ops and library call or None) times the halves of the FFN launch
        apart (the first version's gate_up beside it) into row["up"], which
        a kernel_main row gives its kernel's entry. A W4A8 call's ``fold``
        (fold_pair) runs its kernel folded (quantizing x itself) and
        unfolded on the codes of a prep launch: the two must give the same
        bits, and row["fold"] times the folded kernel beside prep +
        unfolded kernel (for an FFN call the gate_up halves too)."""
        def first_out(o):  # a wrapper with side outputs: the main one
            return o[0] if isinstance(o, tuple) else o

        out, ref = wrapper(), (expect or plain)()
        if isinstance(out, tuple):
            for o, rf in zip(out[1:], ref[1:]):
                if rel_err(o, rf)[1] > (side_tol or tol):
                    raise AssertionError(f"{name} [{label}] side outputs")
            out, ref = out[0], ref[0]
        if kernel is not None and not torch.equal(first_out(wrapper()), out):
            raise AssertionError(f"{name} [{label}] {kernel}: a second call "
                                 "is not bit-identical")
        mae, rel = rel_err(out, ref, per_row)
        ok = rel <= tol and bool(torch.isfinite(out.float()).all())
        launch = launcher()[0]
        ms = time_ms(launch, iters=iters)
        wrapper_ms = time_ms(wrapper, iters=iters)
        first_ms = None
        if first is not None:
            first_launch, f_out = first()
            first_launch()
            first_rel = rel_err(first_out(f_out), ref, per_row)[1]
            if first_rel > tol:
                raise AssertionError(f"{name} [{label}] first version "
                                     f"disagrees: {first_rel}")
            first_ms = time_ms(first_launch, iters=iters)
            del f_out
        # one timed call: the reference call above warmed the plain version
        plain_ms = time_ms(plain, iters=1, warmup=0)
        library_ms = None
        if library is not None:
            try:
                library()
            except (RuntimeError, ValueError, TypeError) as exc:
                # no backend takes the shape
                log(f"kernel {name} [{label}] library call refused: "
                    f"{str(exc).splitlines()[0][:120]}")
            else:
                library_ms = time_ms(library, iters=iters)
        bound, bound_by = bound_of(b_bytes, ops, peak)
        row = dict(name=name, shape=label, max_abs_err=mae, rel_err=rel,
                   tol=tol, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=library_ms, bytes=b_bytes, ops=ops, ok=ok,
                   kernel=kernel, first_ms=first_ms)
        if fold is not None:
            row["fold"] = fold_times(name, label, fold, first_out, iters,
                                     up is not None)
        if up is not None:
            halves = launcher()[0]
            up_bound, up_by = bound_of(up["bytes"], up["ops"], peak)
            down_bound, down_by = bound_of(up["down_bytes"], up["down_ops"],
                                           peak)
            row["up"] = dict(
                ms=time_ms(halves.up, iters=iters),
                down_ms=time_ms(halves.down, iters=iters),
                first_ms=None if first is None else time_ms(
                    first()[0].up, iters=iters),
                plain_ms=time_ms(up["plain"], iters=1, warmup=0),
                library_ms=None if up["library"] is None else time_ms(
                    up["library"], iters=iters),
                bound_ms=up_bound, bound_by=up_by, bytes=up["bytes"],
                ops=up["ops"], down_bound_ms=down_bound,
                down_bound_by=down_by)
            log(f"kernel {name} [{label}] gate_up half: "
                + " ".join(f"{k}={v}" for k, v in row["up"].items()))
        rows.append(row)
        log(f"kernel {name} [{label}] rel_err={rel:.3e} (tol {tol}) "
            f"ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound:.4f} library_ms={library_ms}"
            + ("" if kernel is None else
               f" kernel={kernel} first_ms={first_ms:.4f}"))
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees: {rel}")
        if main:
            entries[name] = row
        if kernel_main:
            entries[kernel] = {**row, **row.get("up", {})}

    return check


def fold_pair(launcher, prep, folds: bool, fits: bool = True) -> dict:
    """check()'s ``fold`` of a W4A8 call: ``launcher(fold)`` gives (launch,
    out) with its kernel folded (True: it quantizes x itself) or unfolded
    (False: it reads the codes of the prep launch the launcher makes);
    ``prep`` runs that prep alone; ``folds`` is what the route does;
    ``fits``: whether the folded kernel takes the shape at all (a
    tensor-core kernel's A tile must fit beside its ring)."""
    return dict(launcher=launcher, prep=prep, folds=folds, fits=fits)


def fold_times(name, label, fold, first_out, iters, ffn) -> dict:
    """The folded kernel beside prep + unfolded kernel on the same operands:
    the same bits, then folded_ms, prep_unfolded_ms (one prep launch and
    the unfolded kernel, timed together) and prep_ms; for an FFN call the
    gate_up halves too."""
    prep = fold["prep"]
    u_launch, u_out = fold["launcher"](False)
    u_launch()
    out = dict(folds=fold["folds"], folded_ms=None,
               prep_unfolded_ms=time_ms(lambda: (prep(), u_launch()),
                                        iters=iters),
               prep_ms=time_ms(prep, iters=iters))
    if fold["fits"]:
        f_launch, f_out = fold["launcher"](True)
        f_launch()
        if not torch.equal(first_out(f_out), first_out(u_out)):
            raise AssertionError(f"{name} [{label}]: the folded kernel and "
                                 "prep + unfolded kernel give other bits")
        out["folded_ms"] = time_ms(f_launch, iters=iters)
    if ffn:
        out["up_prep_unfolded_ms"] = time_ms(lambda: (prep(), u_launch.up()),
                                             iters=iters)
        out["up_folded_ms"] = (time_ms(f_launch.up, iters=iters)
                               if fold["fits"] else None)
    log(f"kernel {name} [{label}] fold (route folds: {fold['folds']}): "
        + " ".join(f"{k}={v}" for k, v in out.items() if k != "folds")
        + (" (same bits)" if fold["fits"] else " (no A tile fits)"))
    return out


def bound_of(b_bytes: int, ops: int, peak: float) -> tuple[float, str]:
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak."""
    t_bytes, t_ops = b_bytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def routed(kernels: dict, route: str, first) -> dict:
    """check() keywords for a call its wrapper routes: where the route is
    one of ``kernels`` ({route: redesigned kernel}), that kernel's name and
    the first version's launcher (``first``) on the same operands; nothing
    where the call keeps the first version."""
    return dict(kernel=kernels[route], first=first) if route in kernels \
        else {}


QM_ROUTES = {"mma": "quant_mma_kernel", "gemv": "quant_gemv_kernel"}
W4A8_ROUTES = {"mma": "w4a8_mma_kernel", "gemv": "w4a8_gemv_kernel"}
FFN_ROUTES = {"mma": "w4a8_ffn_mma_kernel", "gemv": "w4a8_ffn_gemv_kernel"}
QT_ROUTES = {"wgmma": "quant_wgmma_t_kernel"}
MLA_DECODE_ROUTES = {"split": "mla_decode_split_kernel"}
MLA_PREFILL_ROUTES = {"mma": "mla_prefill_mma_kernel"}
MLA_PAGED_DECODE_ROUTES = {"split": "mla_paged_decode_split_kernel"}
GQA_PREFILL_ROUTES = {"mma": "gqa_prefill_mma_kernel"}
GQA_DECODE_ROUTES = {"split": "gqa_decode_split_kernel"}
MLA_ATTENTION_ROUTES = {"split": "mla_decode_split_kernel<false>"}


def grouped_mm(x, wdq, sizes):
    """The library yardstick of the grouped entries: one torch._grouped_mm
    over the bf16-dequantized experts wdq [E, K, N] with offs =
    cumsum(group_sizes) (never on the path), or None where this PyTorch
    has no _grouped_mm."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    return lambda: fn(x, wdq, offs=offs)


def draw(seed: int):
    """(rd, rn, w): a seeded drawer on the card, bf16 normals, and int4_g
    weights repacked for W4A8."""
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    rd = _Draw(seed, torch.device("cuda"), torch.bfloat16)

    def rn(*s):
        return torch.randn(*s, device="cuda", generator=rd.gen).to(
            torch.bfloat16)

    def w(shape, gs=128):
        return repack_offset_lo(rd.q(shape, "int4_g", gs))

    return rd, rn, w


def ffn_up(x, gu, dn, row_expert, used, library=None):
    """check()'s ``up`` of an FFN call on one-row tiles: the gate_up
    half's plain version, its bytes (the gate_up codes and scales of
    the experts used, x in, the requantized codes out) and int8
    operations, and its library yardstick; and the down half's bytes
    (the down codes and scales of the experts used, the requantized
    codes in, bf16 out) and operations."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    r, k = x.shape
    inter = gu.out_features // 2
    gs_dn = MM.group_of(dn)
    hasz = dn.zeros is not None
    gu3 = MM.lift(gu) if gu.data.dim() == 2 else gu
    dn3 = MM.lift(dn) if dn.data.dim() == 2 else dn
    mid = r * (inter + (16 if hasz else 12) * (inter // gs_dn))
    return dict(
        plain=lambda: F.gate_up_ref(x, gu3, gs_dn, row_expert, "silu",
                                    hasz),
        bytes=used * nbytes(*weight_parts(gu3, 0)) + nbytes(x)
        + mid, ops=2 * r * 2 * inter * k, library=library,
        down_bytes=used * nbytes(*weight_parts(dn3, 0)) + mid
        + r * k * 2, down_ops=2 * r * inter * k)


def weight_parts(wt, e=None) -> tuple:
    """The tensors a kernel reads of a W4A8 weight (of expert e of a 3-D
    one): codes, scales and zero points where it has them."""
    parts = (wt.data, wt.scales, wt.zeros)
    return parts if e is None else tuple(
        None if t is None else t[e] for t in parts)


def fold_fits(route, m, k, gs, hasz, stages, bn) -> bool:
    """Whether a W4A8 call's kernel takes x folded at all (fold_pair's
    ``fits``): the GEMV at scale groups of up to 128 (a per-channel group
    is cut into unit runs, which a fold cannot quantize), the tensor-core
    kernels where the group is one of theirs and the A tile fits beside
    the ring."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    if gs > MM.FOLD_MAX_GROUP:
        return False
    if route == "gemv":
        return True
    return (route == "mma" and not MM.mma_wide(gs, k)
            and MM.mma_fold_fits(m, k, gs, stages, bn, zeros=hasz))


def dense_w4a8_check(check, x, wt, label, sms, main=False,
                     kernel_main=False):
    """Row 1 (dense_w4a8_matmul) on x [M, K] and the W4A8 weight wt [K, N]
    through check(): held to its plain version, timed beside the first
    version where the route takes a redesigned kernel, folded and
    unfolded, with torch.matmul on the bf16-dequantized weight as the
    library yardstick."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.formats import dequantize

    m, k = x.shape
    n = wt.out_features
    gs, hasz = MM.group_of(wt), wt.zeros is not None
    wdq = dequantize(wt, torch.bfloat16)
    route = MM.route(m, "dense", gs, n, k)
    check("dense_w4a8_matmul", label, 1e-2,
          lambda: MM.dense_w4a8_matmul(x, wt),
          lambda: MM.w4a8_matmul_ref(x, wt),
          lambda: MM.dense_w4a8_launcher(x, wt),
          nbytes(x, *weight_parts(wt)) + m * n * 2, 2 * m * n * k,
          INT8_OPS_PER_S, library=lambda: torch.matmul(x, wdq), main=main,
          kernel_main=kernel_main, fold=fold_pair(
              lambda f: MM.dense_w4a8_launcher(x, wt, None, f),
              lambda: MM.prep_activations(x, k, wt.group_size, hasz),
              MM.gemv_call_folds(n, 1, 1, k, gs, sms)
              if m == 1 else MM.folds(route, m, k, gs, hasz),
              fold_fits(route, m, k, gs, hasz, MM.MMA_STAGES, 64)),
          **routed(W4A8_ROUTES, route,
                   lambda: MM.dense_w4a8_launcher(x, wt, "rows")))


def dense_ffn_check(check, x, sgu, sdn, label, sms, main=False):
    """Row 3 (dense_w4a8_ffn) on x [M, K], gate_up [K, 2I] and down [I, K]
    through check(); a one-row call's gate_up half is timed apart, with
    torch.matmul on the bf16-dequantized gate_up (no GLU, no requant) as
    its library yardstick."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.formats import dequantize

    m, d = x.shape
    inter = sdn.in_features
    gs, gs_dn = MM.group_of(sgu), MM.group_of(sdn)
    hasz = sgu.zeros is not None
    route = F.ffn_route(m, "dense", gs, gs_dn, inter, d)
    gdq = dequantize(sgu, torch.bfloat16) if route == "gemv" else None
    folds = (F.ffn_gemv_call_folds(1, 1, inter, gs_dn, d, gs, sms)
             if route == "gemv" else F.ffn_folds(route, m, d, gs, hasz))
    check("dense_w4a8_ffn", label, 3e-2,
          lambda: F.dense_w4a8_ffn(x, sgu, sdn),
          lambda: F.dense_w4a8_ffn_ref(x, sgu, sdn),
          lambda: F.dense_launcher(x, sgu, sdn),
          nbytes(*weight_parts(sgu), *weight_parts(sdn))
          + 2 * nbytes(x), 2 * m * 3 * d * inter, INT8_OPS_PER_S,
          main=main, up=None if gdq is None else ffn_up(
              x, sgu, sdn, torch.zeros(1, dtype=torch.int64,
                                       device=x.device),
              1, lambda: torch.matmul(x, gdq)),
          fold=None if route == "split" else fold_pair(
              lambda fo: F.dense_launcher(x, sgu, sdn, "silu", None, fo),
              lambda: MM.prep_activations(x, d, sgu.group_size, hasz),
              folds, fold_fits(route, m, d, gs, hasz, F.FFN_MMA_STAGES,
                               256)),
          **routed(FFN_ROUTES, route,
                   lambda: F.dense_launcher(x, sgu, sdn, "silu", "rows")))


def gathered_mm_check(check, x, wt, ids, label, main=False):
    """Row 7 (gathered_w4a8_matmul): row r of x through expert ids[r] of
    wt [E, K, N]. Bound: x, the codes and scales of the experts the rows
    use and the output over the memory rate, against 2 R N K over the int8
    peak. No library yardstick: no single PyTorch call gathers an expert
    per row."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    rows, k = x.shape
    e, n = wt.data.shape[0], wt.out_features
    gs, hasz = MM.group_of(wt), wt.zeros is not None
    used = int(torch.unique(ids).numel())
    route = MM.route(rows, "gathered", gs, n, k)
    check("gathered_w4a8_matmul", label, 1e-2,
          lambda: MM.gathered_w4a8_matmul(x, wt, ids),
          lambda: MM.gathered_w4a8_matmul_ref(x, wt, ids),
          lambda: MM.gathered_launcher(x, wt, ids),
          nbytes(x) + used * nbytes(*weight_parts(wt, 0)) + rows * n * 2,
          2 * rows * n * k, INT8_OPS_PER_S, main=main, fold=fold_pair(
              lambda f: MM.gathered_launcher(x, wt, ids, None, f),
              lambda: MM.prep_activations(x, k, wt.group_size, hasz),
              MM.gemv_call_folds(n, rows, e, k, gs, MM.sm_count(x.device)),
              fold_fits(route, rows, k, gs, hasz, MM.MMA_STAGES, 64)),
          **routed(W4A8_ROUTES, route,
                   lambda: MM.gathered_launcher(x, wt, ids, "rows")))


def grouped_mm_check(check, x, wt, sizes, label, library=None, main=False):
    """Row 8 (grouped_w4a8_matmul): x [M, K] sorted by expert with the
    group sizes ``sizes`` through wt [E, K, N]; bound as row 7 over the
    experts with rows; ``library`` the grouped_mm yardstick or None."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    rows, k = x.shape
    n = wt.out_features
    gs, hasz = MM.group_of(wt), wt.zeros is not None
    used = int((sizes > 0).sum())
    route = MM.route(rows, "grouped", gs, n, k)
    check("grouped_w4a8_matmul", label, 1e-2,
          lambda: MM.grouped_w4a8_matmul(x, wt, sizes),
          lambda: MM.grouped_w4a8_matmul_ref(x, wt, sizes),
          lambda: MM.grouped_launcher(x, wt, sizes),
          nbytes(x) + used * nbytes(*weight_parts(wt, 0)) + rows * n * 2,
          2 * rows * n * k, INT8_OPS_PER_S, library=library, main=main,
          iters=10, fold=fold_pair(
              lambda f: MM.grouped_launcher(x, wt, sizes, None, f),
              lambda: MM.prep_activations(x, k, wt.group_size, hasz),
              MM.folds(route, rows, k, gs, hasz),
              fold_fits(route, rows, k, gs, hasz, MM.MMA_STAGES, 64)),
          **routed(W4A8_ROUTES, route,
                   lambda: MM.grouped_launcher(x, wt, sizes, "rows")))


def kernel_checks(rows: list, entries: dict) -> None:
    """The first twelve kernels at the DeepSeek-V2-Lite shapes (see
    make_check)."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.rope import (
        RopeConfig,
        precompute_rope_tables,
        rope_rotation_matrix,
    )

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    rd, rn, w = draw(1234)
    sms = MM.sm_count(dev)

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

    # row 1: dense_w4a8_matmul; M = 1 takes w4a8_gemv_kernel, M >=
    # MM.MMA_MIN_ROWS w4a8_mma_kernel, each held and timed beside the first
    # version on the same operands
    row1 = [
        (1, 2048, 3648, "decode qkv_a M=1", "main"),
        (1, 2048, 2048, "decode o_proj M=1", ""),
        (1, 2048, 102400, "decode lm_head M=1", ""),
        (1, 2048, 21888, "decode layer-0 gate_up M=1", ""),
        (1, 10944, 2048, "decode layer-0 down M=1 (gs 96)", ""),
        (2, 2048, 3648, "qkv_a M=2", ""),
        (8, 2048, 3648, "serve decode qkv_a M=8", ""),
    ]
    for k, n, what in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                       (10944, 2048, "layer-0 down (gs 96)")):
        for m, where in ((16, ""), (64, ""), (256, "prefill "),
                         (520, "serve mixed "), (1024, "serve prefill-only ")):
            row1.append((m, k, n, f"{where}{what} M={m}",
                         "kernel_main" if (what, m) == ("qkv_a", 256)
                         else ""))
    for k, n, what in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                       (2048, 5632, "shared gate_up"),
                       (2816, 2048, "shared down"),
                       (2048, 21888, "layer-0 gate_up"),
                       (2048, 102400, "lm_head")):
        row1.append((SFT_SEQ, k, n, f"sft {what} M={SFT_SEQ}", ""))
    for m, k, n, label, main in row1:
        wt, x = w((k, n)), rn(m, k)
        dense_w4a8_check(check, x, wt, label, sms, main=main == "main",
                         kernel_main=main in ("main", "kernel_main"))
        del wt

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
          INT8_OPS_PER_S, main=True, kernel_main=True,
          up=ffn_up(x, gu, dn, ids.long(), 6),
          fold=fold_pair(
              lambda fo: F.gathered_launcher(x, gu, dn, ids, "silu", None,
                                             fo),
              lambda: MM.prep_activations(x, d, 128),
              F.ffn_gemv_call_folds(6, e, f, 128, d, 128, sms)),
          **routed(FFN_ROUTES, F.ffn_route(6, "gathered", 128, 128, f, d),
                   lambda: F.gathered_launcher(x, gu, dn, ids, "silu",
                                               "rows")))

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
          INT8_OPS_PER_S, main=True, kernel_main=True, fold=fold_pair(
              lambda fo: F.grouped_launcher(xs, gu, dn, sizes, "silu", None,
                                            fo),
              lambda: MM.prep_activations(xs, d, 128),
              F.ffn_folds(F.ffn_route(1536, "grouped", 128, 128, f, d),
                          1536, d, 128),
              MM.mma_fold_fits(1536, d, 128, F.FFN_MMA_STAGES, 256)),
          **routed(FFN_ROUTES, F.ffn_route(1536, "grouped", 128, 128, f, d),
                   lambda: F.grouped_launcher(xs, gu, dn, sizes, "silu",
                                              "rows")))
    del gu, dn

    # row 3: dense_w4a8_ffn (the shared experts, 2 x 1408; the layer-0
    # MLP takes two dense_w4a8_matmul calls, as in the JAX package)
    for m, inter, label, main in (
        (1, 2816, "decode shared M=1 I=2816", True),
        (256, 2816, "prefill shared M=256", False),
    ):
        sgu, sdn, x = w((d, 2 * inter)), w((inter, d)), rn(m, d)
        dense_ffn_check(check, x, sgu, sdn, label, sms, main=main)
        del sgu, sdn

    # row 5: mla_decode_fused (16 heads, R 512, dr 64) at 512 cached rows
    # of the Generator's 1024 (the main path), and at 2048 and 4095 (the
    # current token fills the cache) of 4096; every cache row at or past
    # the length is NaN. bf16 takes mla_decode_split_kernel, the first
    # version is timed beside it.
    b, h, r, dr = 1, 16, 512, 64
    cos, sin = precompute_rope_tables(RopeConfig(dim=dr, max_position=4096,
                                                 interleaved=True), dev)
    for smax, length in ((1024, 512), (4096, 2048), (4096, 4095)):
        rot = rope_rotation_matrix(cos[length][None], sin[length][None],
                                   True)
        qn, qp, kv = rn(b, h, r), rn(b, h, dr), rn(b, 1, r + dr)
        gamma = torch.ones(r, device=dev)
        ckv, kpe = rn(b, smax, r), rn(b, smax, dr)
        ckv[:, length:] = float("nan")
        kpe[:, length:] = float("nan")
        lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
        args = (qn, qp, kv, gamma, rot, ckv, kpe, lengths,
                (128 + 64) ** -0.5, 1e-6)
        # library yardstick: one SDPA over q = [qn | qp], k = [ckv | kpe],
        # v = ckv on the length + 1 rows (norm and rope of the new row left
        # out; its row taken from the cache, NaN-free)
        lib_c = torch.nan_to_num(ckv[:, : length + 1])
        lib_q = torch.cat([qn, qp], dim=-1)[:, :, None]
        lib_k = torch.cat([lib_c, torch.nan_to_num(kpe[:, : length + 1])],
                          dim=-1)[:, None].expand(-1, h, -1, -1)
        lib_v = lib_c[:, None].expand(-1, h, -1, -1)
        main = length == 512
        check("mla_decode_fused", f"decode H=16 cached={length} S={smax}",
              1e-2, lambda args=args: MD.mla_decode_fused(*args),
              lambda args=args: MD.mla_decode_fused_ref(*args),
              lambda args=args: MD.mla_launcher(*args),
              length * (r + dr) * 2 + nbytes(qn, qp, kv) + b * h * r * 2,
              2 * h * (length + 1) * (2 * r + dr), BF16_FLOPS_PER_S,
              main=main, kernel_main=main,
              library=lambda q=lib_q, k=lib_k, v=lib_v:
              tF.scaled_dot_product_attention(q, k, v,
                                              scale=(128 + 64) ** -0.5),
              **routed(MLA_DECODE_ROUTES, MD.route(torch.bfloat16),
                       lambda args=args: MD.mla_launcher(*args, "fused")))
        del ckv, kpe, lib_c, lib_k, lib_v

    # ---- the serving path's row counts through the W4A8 kernels (a decode
    # batch of 8 and mixed steps of 8 + 2*256 rows at qkv_a above): 48
    # gathered rows
    gu, dn = w((e, d, 2 * f)), w((e, f, d))
    g_cpu = torch.Generator().manual_seed(2)
    ids48 = torch.stack([torch.randperm(e, generator=g_cpu)[:6]
                         for _ in range(8)]).reshape(-1)
    x = rn(48, d)
    ids48 = ids48.to(torch.int32).to(dev)
    check("gathered_w4a8_ffn", "serve decode 48 rows (8 tok x 6)", 3e-2,
          lambda: F.gathered_w4a8_ffn(x, gu, dn, ids48),
          lambda: F.gathered_w4a8_ffn_ref(x, gu, dn, ids48),
          lambda: F.gathered_launcher(x, gu, dn, ids48),
          int(ids48.unique().numel()) * per_expert + 2 * nbytes(x),
          2 * 48 * 3 * d * f, INT8_OPS_PER_S,
          up=ffn_up(x, gu, dn, ids48.long(), int(ids48.unique().numel())),
          fold=fold_pair(
              lambda fo: F.gathered_launcher(x, gu, dn, ids48, "silu", None,
                                             fo),
              lambda: MM.prep_activations(x, d, 128),
              F.ffn_gemv_call_folds(48, e, f, 128, d, 128, sms)),
          **routed(FFN_ROUTES, F.ffn_route(48, "gathered", 128, 128, f, d),
                   lambda: F.gathered_launcher(x, gu, dn, ids48, "silu",
                                               "rows")))
    topk = torch.stack([torch.randperm(e, generator=g_cpu)[:6]
                        for _ in range(520)]).to(dev)
    sizes = torch.bincount(topk.reshape(-1), minlength=e).to(torch.int32)
    xs = rn(3120, d)
    check("grouped_w4a8_ffn", "serve mixed 3120 rows (520 tok x 6)", 3e-2,
          lambda: F.grouped_w4a8_ffn(xs, gu, dn, sizes),
          lambda: F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes),
          lambda: F.grouped_launcher(xs, gu, dn, sizes),
          int((sizes > 0).sum()) * per_expert + 2 * nbytes(xs),
          2 * 3120 * 3 * d * f, INT8_OPS_PER_S, fold=fold_pair(
              lambda fo: F.grouped_launcher(xs, gu, dn, sizes, "silu", None,
                                            fo),
              lambda: MM.prep_activations(xs, d, 128),
              F.ffn_folds(F.ffn_route(3120, "grouped", 128, 128, f, d),
                          3120, d, 128),
              MM.mma_fold_fits(3120, d, 128, F.FFN_MMA_STAGES, 256)),
          **routed(FFN_ROUTES, F.ffn_route(3120, "grouped", 128, 128, f, d),
                   lambda: F.grouped_launcher(xs, gu, dn, sizes, "silu",
                                              "rows")))
    del gu, dn
    for m, label in ((8, "serve decode shared M=8"),
                     (520, "serve mixed shared M=520")):
        sgu, sdn, x = w((d, 2 * 2816)), w((2816, d)), rn(m, d)
        check("dense_w4a8_ffn", label, 3e-2,
              lambda: F.dense_w4a8_ffn(x, sgu, sdn),
              lambda: F.dense_w4a8_ffn_ref(x, sgu, sdn),
              lambda: F.dense_launcher(x, sgu, sdn),
              nbytes(sgu.data, sgu.scales, sdn.data, sdn.scales)
              + 2 * nbytes(x), 2 * m * 3 * d * 2816, INT8_OPS_PER_S,
              fold=fold_pair(
                  lambda fo: F.dense_launcher(x, sgu, sdn, "silu", None, fo),
                  lambda: MM.prep_activations(x, d, 128),
                  F.ffn_folds(F.ffn_route(m, "dense", 128, 128, 2816, d),
                              m, d, 128),
                  MM.mma_fold_fits(m, d, 128, F.FFN_MMA_STAGES, 256)),
              **routed(FFN_ROUTES, F.ffn_route(m, "dense", 128, 128, 2816,
                                               d),
                       lambda: F.dense_launcher(x, sgu, sdn, "silu",
                                                "rows")))
        del sgu, sdn

    paged_kernel_checks(check, rn, dev)
    quant_kernel_checks(check, rd, rn, dev)
    decode_attention_checks(check, rn, dev)


QUANT_KINDS = ("int8", "fp8", "int4", "int4_g", "int4_gz", "mxfp4", "mxfp8")


def quant_kernel_checks(check, rd, rn, dev) -> None:
    """Rows 9-11: quant_matmul, gathered_quant_matmul and
    grouped_quant_matmul for each weight format at the DeepSeek-V2-Lite
    shapes of the int8 path, bf16 activations, against the plain version on
    the card. Tolerance 1e-2 of the largest output: both sides decode and
    round the weight identically and accumulate in float32; what differs is
    the order of the sums and one bf16 rounding of the output. Bound: x,
    the weight bytes of the experts the rows use (codes, scales, zero
    points) and the output over the memory rate, against 2 M K N over the
    bf16 peak (the activations' type). Library yardstick, row 9 only:
    torch.matmul on the bf16-dequantized weight (never on the path). int8
    is the main path's format and gets 20 timed launches, the others 10."""
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
    from ktransformers_tpu_torch.quant.formats import dequantize

    bf = torch.bfloat16
    e, d, f = 64, 2048, 1408

    def wbytes(wt, experts=None):
        per = [t for t in (wt.data, wt.scales, wt.zeros) if t is not None]
        if experts is None:
            return nbytes(*per)
        return experts * nbytes(*(t[0] for t in per))

    g_cpu = torch.Generator().manual_seed(3)

    def routing(tokens):
        return torch.stack([torch.randperm(e, generator=g_cpu)[:6]
                            for _ in range(tokens)]).to(dev)

    ids6 = routing(1).reshape(-1).to(torch.int32)
    ids48 = routing(8).reshape(-1).to(torch.int32)
    # sorted rows of 256 / 520 tokens x 6; the last 4 tokens' 24 rows are
    # past sum(group_sizes): masked, they must come back zero
    sizes = {t * 6: torch.bincount(routing(t - 4).reshape(-1),
                                   minlength=e).to(torch.int32)
             for t in (256, 520)}

    def dense_shapes(kind):
        yield from ((1, 2048, 3648, "decode qkv_a M=1"),
                    (1, 2048, 2048, "decode o_proj M=1"),
                    (8, 2048, 3648, "serve decode qkv_a M=8"),
                    (256, 2048, 3648, "prefill qkv_a M=256"),
                    (1, 2048, 102400, "decode lm_head M=1"),
                    (1, 10944, 2048, "decode layer-0 down M=1"))
        if kind == "int4_g":  # a group of 96: 48 storage rows a group
            yield 256, 10944, 2048, "prefill layer-0 down M=256 (gs 96)"
        if kind != "int8":
            return
        yield 2, 2048, 3648, "qkv_a M=2"
        for k, n, what in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                           (10944, 2048, "layer-0 down")):
            for m in (16, 64, 256, 520, 1024):
                if (what, m) != ("qkv_a", 256):
                    yield m, k, n, f"{what} M={m}"

    for kind in QUANT_KINDS:
        it = 20 if kind == "int8" else 10
        for m, k, n, label in dense_shapes(kind):
            wt, x = rd.q((k, n), kind, 128), rn(m, k)
            wdq = dequantize(wt, bf)
            check("quant_matmul", f"{kind} {label}", 1e-2,
                  lambda: QM.quant_matmul(x, wt),
                  lambda: QM.quant_matmul_ref(x, wt),
                  lambda: QM.dense_launcher(x, wt),
                  nbytes(x) + wbytes(wt) + m * n * 2, 2 * m * n * k,
                  BF16_FLOPS_PER_S, library=lambda: torch.matmul(x, wdq),
                  main=(kind == "int8" and m == 1 and n == 3648),
                  kernel_main=(kind == "int8" and m in (1, 256)
                               and n == 3648),
                  iters=it,
                  **routed(QM_ROUTES, QM.route(
                      x.dtype, m, "dense", kind, k, n,
                      QM.rows_per_group(wt)),
                      lambda: QM.dense_launcher(x, wt, "rows")))
            del wdq, wt
        for k, n, what in ((d, 2 * f, "gate_up"), (f, d, "down")):
            wt = rd.q((e, k, n), kind, 128)
            for ids, label in ((ids6, "decode 6 rows"),
                               (ids48, "serve decode 48 rows")):
                x = rn(ids.shape[0], k)
                check("gathered_quant_matmul",
                      f"{kind} {label} {what} [64, {k}, {n}]", 1e-2,
                      lambda: QM.gathered_quant_matmul(x, wt, ids),
                      lambda: QM.gathered_quant_matmul_ref(x, wt, ids),
                      lambda: QM.gathered_launcher(x, wt, ids),
                      nbytes(x) + wbytes(wt, int(ids.unique().numel()))
                      + ids.shape[0] * n * 2, 2 * ids.shape[0] * n * k,
                      BF16_FLOPS_PER_S,
                      main=(kind == "int8" and what == "gate_up"
                            and ids is ids6), iters=it,
                      **routed(QM_ROUTES, QM.route(
                          x.dtype, ids.shape[0], "gathered", kind, k, n,
                          QM.rows_per_group(wt)),
                          lambda: QM.gathered_launcher(x, wt, ids, "rows")))
            wdq = dequantize(wt, bf)
            for rows, sz in sizes.items():
                x = rn(rows, k)
                live = int(sz.sum())
                out = QM.grouped_quant_matmul(x, wt, sz)
                if live != rows - 24 or bool(out[live:].abs().max() != 0):
                    raise AssertionError(
                        f"grouped_quant_matmul {kind}: masked rows not zero")
                check("grouped_quant_matmul",
                      f"{kind} {rows} sorted rows ({live} live) {what} "
                      f"[64, {k}, {n}]", 1e-2,
                      lambda: QM.grouped_quant_matmul(x, wt, sz),
                      lambda: QM.grouped_quant_matmul_ref(x, wt, sz),
                      lambda: QM.grouped_launcher(x, wt, sz),
                      nbytes(x) + wbytes(wt, int((sz > 0).sum()))
                      + rows * n * 2, 2 * live * n * k, BF16_FLOPS_PER_S,
                      library=grouped_mm(x, wdq, sz),
                      main=(kind == "int8" and what == "gate_up"
                            and rows == 1536), iters=it,
                      **routed(QM_ROUTES, QM.route(
                          x.dtype, rows, "grouped", kind, k, n,
                          QM.rows_per_group(wt)),
                          lambda: QM.grouped_launcher(x, wt, sz, "rows")))
            del wt, wdq


def decode_attention_checks(check, rn, dev) -> None:
    """Row 6: mla_decode_attention (16 heads, R 512, dr 64, bf16) at B = 1
    with 512 and 2048 live rows and at B = 8 with lengths 1..2048; every
    cache row at or past lengths[b] is NaN. bf16 takes
    mla_decode_split_kernel<false>, the first version timed beside it;
    every output row is held to 1e-2 of its own largest value. Bound: the
    bytes of the live rows, queries and output against the flops of the
    live (query, key) pairs at the bf16 peak. Library yardstick: one
    F.scaled_dot_product_attention over q = [qn | qp], k = [ckv | kpe],
    v = ckv with a length mask, on a NaN-free copy of the cache (never on
    the path)."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD

    h, r, dr, smax = 16, 512, 64, 2048
    scale = (128 + 64) ** -0.5
    for lens, main in (([512], True), ([2048], False),
                       ([1, 64, 65, 512, 513, 1000, 2047, 2048], False)):
        b = len(lens)
        qn, qp = rn(b, h, r), rn(b, h, dr)
        ckv, kpe = rn(b, smax, r), rn(b, smax, dr)
        for i, n in enumerate(lens):
            ckv[i, n:] = float("nan")
            kpe[i, n:] = float("nan")
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (qn, qp, ckv, kpe, lengths, scale)
        live = sum(lens)
        lib_q = torch.cat([qn, qp], dim=-1)[:, :, None]
        lib_k = torch.nan_to_num(torch.cat([ckv, kpe], dim=-1))[:, None]
        lib_mask = (torch.arange(smax, device=dev)[None]
                    < lengths[:, None])[:, None, None]
        check("mla_decode_attention",
              f"decode B={b} H=16 lengths {lens[0]}..{lens[-1]}", 1e-2,
              lambda: MD.mla_decode_attention(*args),
              lambda: MD.mla_decode_attention_ref(*args),
              lambda: MD.attention_launcher(*args),
              live * (r + dr) * 2 + nbytes(qn, qp) + b * h * r * 2,
              2 * h * live * (2 * r + dr), BF16_FLOPS_PER_S, main=main,
              kernel_main=main, per_row=True,
              library=lambda: tF.scaled_dot_product_attention(
                  lib_q, lib_k.expand(-1, h, -1, -1),
                  lib_k[..., :r].expand(-1, h, -1, -1), attn_mask=lib_mask,
                  scale=scale),
              **routed(MLA_ATTENTION_ROUTES,
                       MD.attention_route(torch.bfloat16),
                       lambda: MD.attention_launcher(*args, kernel="first")))


def paged_kernel_checks(check, rn, dev, h: int = 16,
                        scale: float = (128 + 64) ** -0.5,
                        prefix: str = "") -> None:
    """Rows 12 and 14: mla_paged_decode and mla_paged_prefill at the
    serving shapes (``h`` heads, 16 for DeepSeek-V2-Lite, R 512, dr 64,
    page 64, 32 pages a query, bf16), shuffled page tables, every pool row
    the kernels must not read NaN; with a ``prefix`` (another model's
    shapes) only the main page size and the mixed step's chunks, and no
    entry of the kernels line; bf16 decode takes mla_paged_decode_split_kernel and bf16 prefill
    mla_prefill_mma_kernel, each with its first version timed beside it. Bound: the bytes of the live rows + queries + output over the
    memory rate, against the flops of the live (query, key) pairs over
    the bf16 peak. Library yardstick: gather the pages, then
    F.scaled_dot_product_attention on K = [ckv | kpe], V = ckv (gather
    time included; on a NaN-free copy of the pool; never on the path)."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    r, dr = 512, 64
    bf = torch.bfloat16

    def pool(live, page, pmax):
        b = len(live)
        n = b * pmax + 1
        perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
            page + b)) + 1
        tables = perm[: b * pmax].reshape(b, pmax).to(torch.int32).to(dev)
        ckv = torch.full((n, page, r), float("nan"), dtype=bf, device=dev)
        kpe = torch.full((n, page, dr), float("nan"), dtype=bf, device=dev)
        for i, ln in enumerate(live):
            pos = torch.arange(ln, device=dev)
            rows = tables[i].long()[pos // page] * page + pos % page
            ckv.view(-1, r)[rows] = rn(ln, r)
            kpe.view(-1, dr)[rows] = rn(ln, dr)
        return ckv, kpe, tables

    def sdpa(q, ckv0, kpe0, tables, mask):
        k = torch.cat([PA.gather_pages(ckv0, tables),
                       PA.gather_pages(kpe0, tables)], dim=-1)[:, None]
        v = k[..., :r]
        hq = q.shape[1]
        return tF.scaled_dot_product_attention(
            q, k.expand(-1, hq, -1, -1), v.expand(-1, hq, -1, -1),
            attn_mask=mask, scale=scale)

    # decode: B = 8, lengths on and around page boundaries
    lens = [1, 64, 65, 512, 513, 1000, 2047, 2048]
    pages = ((64, 32, True), (16, 128, False), (128, 16, False))
    for page, pmax, main in pages[:3 if not prefix else 1]:
        main = main and not prefix
        ckv, kpe, tables = pool(lens, page, pmax)
        qn, qp = rn(8, h, r), rn(8, h, dr)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (qn, qp, ckv, kpe, tables, lengths, scale)
        ckv0, kpe0 = torch.nan_to_num(ckv), torch.nan_to_num(kpe)
        kpos = torch.arange(page * pmax, device=dev)
        mask = (kpos[None] < lengths[:, None])[:, None, None]
        q = torch.cat([qn, qp], dim=-1)[:, :, None]
        live = sum(lens)
        check("mla_paged_decode",
              f"{prefix}serve decode B=8 H={h} page={page} lengths 1..2048",
              1e-2,
              lambda: PA.mla_paged_decode(*args),
              lambda: PA.mla_paged_decode_ref(*args),
              lambda: PA.decode_launcher(*args),
              live * (r + dr) * 2 + nbytes(qn, qp) + 8 * h * r * 2,
              2 * h * live * (2 * r + dr), BF16_FLOPS_PER_S,
              library=lambda: sdpa(q, ckv0, kpe0, tables, mask), main=main,
              kernel_main=main,
              **routed(MLA_PAGED_DECODE_ROUTES,
                       PA.decode_route(torch.bfloat16),
                       lambda: PA.decode_launcher(*args, kernel="first")))
        del ckv, kpe, ckv0, kpe0

    # prefill: chunks of a mixed step (S = 256) and of a prefill-only step
    # (S = 512), fresh and continued, full and padded
    chunks = (([256], 256, [256], True), ([0, 256], 256, [256, 200], False),
              ([0], 512, [512], False), ([0, 256], 512, [512, 456], False))
    for olds, s, valids, main in chunks[:4 if not prefix else 2]:
        main = main and not prefix
        c, page, pmax = len(olds), 64, 32
        ckv, kpe, tables = pool([o + v for o, v in zip(olds, valids)], page,
                                pmax)
        qn, qp = rn(c, h, s, r), rn(c, h, s, dr)
        lengths = torch.tensor(olds, dtype=torch.int32, device=dev)
        valid = torch.tensor(valids, dtype=torch.int32, device=dev)
        args = (qn, qp, ckv, kpe, tables, lengths, valid, scale)
        ckv0, kpe0 = torch.nan_to_num(ckv), torch.nan_to_num(kpe)
        kpos = torch.arange(page * pmax, device=dev)[None, None]
        qpos = lengths[:, None] + torch.arange(s, device=dev)[None]
        mask = ((kpos <= qpos[:, :, None])
                & (kpos < (lengths + valid)[:, None, None]))[:, None]
        q = torch.cat([qn, qp], dim=-1)
        pairs = sum(v * o + v * (v + 1) // 2 for o, v in zip(olds, valids))
        # rows >= valid are padding: they see every live key, in the plain
        # version as in both kernels, and are compared too
        check("mla_paged_prefill",
              f"{prefix}serve prefill C={c} S={s} H={h} old={olds} "
              f"valid={valids}", 1e-2,
              lambda: PA.mla_paged_prefill(*args),
              lambda: PA.mla_paged_prefill_ref(*args),
              lambda: PA.prefill_launcher(*args),
              sum(o + v for o, v in zip(olds, valids)) * (r + dr) * 2
              + nbytes(qn, qp) + c * h * s * r * 2,
              2 * h * pairs * (2 * r + dr), BF16_FLOPS_PER_S,
              library=lambda: sdpa(q, ckv0, kpe0, tables, mask), main=main,
              kernel_main=main, **routed(MLA_PREFILL_ROUTES, PA.prefill_route(torch.bfloat16),
                       lambda: PA.prefill_launcher(*args, kernel="first")))
        out = PA.mla_paged_prefill(*args)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("mla_paged_prefill: padding rows not finite")
        del ckv, kpe, ckv0, kpe0


def mixtral_cfg():
    from ktransformers_tpu_torch.models.spec import MIXTRAL_8X7B

    return dict(MIXTRAL_8X7B)


def mixtral_kernel_checks(rows: list, entries: dict) -> None:
    """Rows 7, 8, 13 and 15 at the Mixtral-8x7B shapes of the main paths,
    bf16, against their plain versions on the card (see make_check).

    Rows 7-8 (gathered / grouped W4A8 matmul): experts gate_up [8, 4096,
    28672] and down [8, 14336, 4096] (int4_g, group 128, repacked). Bound:
    x, the weight bytes (codes and scales) of the experts the rows use and
    the output over the memory rate, against 2 R N K over the int8 peak.
    Row 8 takes w4a8_mma_kernel, timed beside the first version; its
    library yardstick is torch._grouped_mm on the bf16-dequantized experts
    (grouped_mm). Row 7 has none: no single PyTorch call gathers an expert
    per row. Rows 13 and 15 (GQA paged attention, 32 query heads over 8
    KV heads of 128, page 64, bf16) on GQA_SERVE_CASES by gqa_cases_checks
    (decode on gqa_decode_split_kernel, prefill on gqa_prefill_mma_kernel,
    each with its first version timed beside it): every pool row the
    kernels must not read is NaN; every output row (sequence, head,
    position) is held to 1e-2 of its own largest value, so that a short
    sequence's large outputs set no scale for a long one's (one bf16 step
    is at most 2^-7 of the row's largest value); their first decode and
    prefill rows are the kernels line's entries."""
    from ktransformers_tpu_torch.quant.formats import dequantize

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    rd, rn, w = draw(4321)
    e, d, f = 8, 4096, 14336
    g_cpu = torch.Generator().manual_seed(7)

    def routing(tokens):
        """Top-2 of 8 experts per token, drawn as the router would pick
        them from softmax scores of random logits."""
        logits = torch.randn(tokens, e, generator=g_cpu)
        return torch.topk(logits, 2, dim=-1).indices.to(dev)

    # row 9: Mixtral's int8 projections at single-user decode (M = 1, the
    # GEMV beside the first version); the library yardstick is torch.matmul
    # on the bf16-dequantized weight
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM

    for k, n, label in ((d, 6144, "qkv 4096->6144"),
                        (d, d, "o_proj 4096->4096"),
                        (d, 32000, "lm_head 4096->32000")):
        wt, x = rd.q((k, n), "int8", 128), rn(1, k)
        wdq = dequantize(wt, torch.bfloat16)
        check("quant_matmul", f"mixtral int8 decode {label} M=1", 1e-2,
              lambda: QM.quant_matmul(x, wt),
              lambda: QM.quant_matmul_ref(x, wt),
              lambda: QM.dense_launcher(x, wt),
              nbytes(x, wt.data, wt.scales) + n * 2, 2 * n * k,
              BF16_FLOPS_PER_S, library=lambda: torch.matmul(x, wdq),
              **routed(QM_ROUTES, QM.route(x.dtype, 1, "dense", "int8", k, n,
                                           QM.rows_per_group(wt)),
                       lambda: QM.dense_launcher(x, wt, "rows")))
        del wt, wdq

    for k, n, what in ((d, 2 * f, "gate_up"), (f, d, "down")):
        wt = w((e, k, n))
        for tokens, label in ((1, "decode 2 rows (1 tok x 2)"),
                              (8, "serve decode 16 rows (8 tok x 2)")):
            ids = routing(tokens).reshape(-1).to(torch.int32)
            gathered_mm_check(check, rn(ids.shape[0], k), wt, ids,
                              f"{label} {what} [8, {k}, {n}]",
                              main=(what == "gate_up" and tokens == 1))
        wdq = dequantize(wt, torch.bfloat16)
        for tokens, label in ((256, "prefill 512 rows (256 tok x 2)"),
                              (264, "serve mixed 528 rows (264 tok x 2)")):
            sizes = torch.bincount(routing(tokens).reshape(-1),
                                   minlength=e).to(torch.int32)
            x = rn(2 * tokens, k)
            grouped_mm_check(check, x, wt, sizes,
                             f"{label} {what} [8, {k}, {n}]",
                             library=grouped_mm(x, wdq, sizes),
                             main=(what == "gate_up" and tokens == 256))
        del wt, wdq

    gqa_cases_checks(check, rn, 32, 8, 128, GQA_SERVE_CASES, "mixtral ",
                     main=True)


# rows 13 and 15 at a served GQA shape (gqa_cases_checks, head dim 128): a
# decode batch of 8 with lengths on and around page boundaries at window 0
# and 512, and prefill chunks (a mixed step's chunk after 256 tokens; a
# fresh full chunk beside a continued padded one)
GQA_SERVE_LENGTHS = [1, 64, 65, 512, 513, 1000, 2047, 2048]
GQA_SERVE_CASES = (("decode", GQA_SERVE_LENGTHS, 0),
                   ("decode", GQA_SERVE_LENGTHS, 512),
                   ("prefill", [256], [256], 0),
                   ("prefill", [0, 256], [256, 200], 0))


def gqa_cases_checks(check, rn, h: int, hkv: int, hd: int, cases, tag: str,
                     dtype=torch.bfloat16, main: bool = False) -> None:
    """Rows 13 and 15 at ``h`` query heads over ``hkv`` KV heads of ``hd``,
    page 64, on shuffled page tables: each case ("decode", lengths,
    window) or ("prefill", old lengths, valid, window) against its plain
    version, every row held to 1e-2 (bf16) or 1e-5 (float32) of its own
    largest value. Every pool row the kernels must not read is NaN: rows at
    or past a sequence's live length, and (K rows, which the plain version
    masks by position) the keys before a decode's window or before the
    first query's window of a chunk. bf16 calls take the redesigned
    kernels, each first version timed beside them. Bound: the K and V
    rows in the windows (each read once) plus q and the output, against
    the bf16 operations of the two products. Library: SDPA on a gathered
    contiguous copy (NaN zeroed), gathered before the timing. ``main``
    makes the first decode and the first prefill case the kernels line's
    entries (the wrappers' and the redesigned kernels')."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    dev = torch.device("cuda")
    page = 64
    scale = hd ** -0.5
    f32 = dtype == torch.float32
    tol = 1e-5 if f32 else 1e-2
    entered = set()  # the kinds whose kernels-line entry is taken

    def pool(live, hidden):
        """Pools and tables over sequences of ``live`` keys, K rows below
        ``hidden`` (per sequence) NaN as well."""
        b = len(live)
        pmax = -(-max(live) // page) + 1
        n = b * pmax + 1
        perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
            b * 7 + hd)) + 1
        tables = perm[: b * pmax].reshape(b, pmax).to(torch.int32).to(dev)
        k = torch.full((n, page, hkv, hd), float("nan"), dtype=dtype,
                       device=dev)
        v = torch.full_like(k, float("nan"))
        for i, ln in enumerate(live):
            pos = torch.arange(ln, device=dev)
            rows_ = tables[i].long()[pos // page] * page + pos % page
            k.view(-1, hkv, hd)[rows_] = rn(ln, hkv, hd).to(dtype)
            v.view(-1, hkv, hd)[rows_] = rn(ln, hkv, hd).to(dtype)
            k.view(-1, hkv, hd)[rows_[: hidden[i]]] = float("nan")
        return k, v, tables

    def gathered(k, v, tables):
        return (PA.gather_pages(torch.nan_to_num(k), tables).transpose(1, 2),
                PA.gather_pages(torch.nan_to_num(v), tables).transpose(1, 2))

    for case in cases:
        entry = main and case[0] not in entered
        entered.add(case[0])
        if case[0] == "decode":
            _, lens, window = case
            seen = [min(n, window) if window else n for n in lens]
            k, v, tables = pool(lens, [n - s for n, s in zip(lens, seen)])
            b = len(lens)
            q = rn(b, h, hd).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (q, k, v, tables, lengths, scale)
            kg, vg = gathered(k, v, tables)
            kpos = torch.arange(kg.shape[2], device=dev)[None]
            ok = kpos < lengths[:, None]
            if window:
                ok = ok & (kpos >= lengths[:, None] - window)
            route = PA.gqa_decode_route(dtype)
            check("gqa_paged_decode",
                  f"{tag}decode B={b} H={h} Hkv={hkv} D={hd} {dtype} "
                  f"lengths {lens} window={window}", tol,
                  lambda: PA.gqa_paged_decode(*args, window=window),
                  lambda: PA.gqa_paged_decode_ref(*args, window=window),
                  lambda: PA.gqa_decode_launcher(*args, window=window),
                  sum(seen) * hkv * hd * 2 * k.element_size()
                  + nbytes(q) * 2, 2 * 2 * h * sum(seen) * hd,
                  BF16_FLOPS_PER_S,
                  library=lambda: tF.scaled_dot_product_attention(
                      q[:, :, None], kg, vg, attn_mask=ok[:, None, None],
                      scale=scale, enable_gqa=True),
                  per_row=True, main=entry, kernel_main=entry,
                  **routed(GQA_DECODE_ROUTES, route,
                           lambda: PA.gqa_decode_launcher(
                               *args, window=window, kernel="first")))
        else:
            _, olds, valids, window = case
            c, s = len(olds), max(valids)
            live = [o + vl for o, vl in zip(olds, valids)]
            first = [max(0, o - window + 1) if window else 0 for o in olds]
            k, v, tables = pool(live, first)
            q = rn(c, h, s, hd).to(dtype)
            lengths = torch.tensor(olds, dtype=torch.int32, device=dev)
            valid = torch.tensor(valids, dtype=torch.int32, device=dev)
            args = (q, k, v, tables, lengths, valid, scale)
            kg, vg = gathered(k, v, tables)
            kp = torch.arange(kg.shape[2], device=dev)[None, None]
            qpos = lengths[:, None] + torch.arange(s, device=dev)[None]
            mask = ((kp <= qpos[:, :, None])
                    & (kp < (lengths + valid)[:, None, None]))
            if window:
                mask = mask & (kp > qpos[:, :, None] - window)
            pairs = sum(min(o + j + 1, window) if window else o + j + 1
                        for o, vl in zip(olds, valids) for j in range(vl))
            keys = sum(n - f for n, f in zip(live, first))
            route = PA.gqa_prefill_route(dtype)
            check("gqa_paged_prefill",
                  f"{tag}prefill C={c} S={s} H={h} Hkv={hkv} D={hd} {dtype} "
                  f"old={olds} valid={valids} window={window}", tol,
                  lambda: PA.gqa_paged_prefill(*args, window=window),
                  lambda: PA.gqa_paged_prefill_ref(*args, window=window),
                  lambda: PA.gqa_prefill_launcher(*args, window=window),
                  keys * hkv * hd * 2 * k.element_size() + nbytes(q) * 2,
                  2 * 2 * h * pairs * hd, BF16_FLOPS_PER_S,
                  library=lambda: tF.scaled_dot_product_attention(
                      q, kg, vg, attn_mask=mask[:, None], scale=scale,
                      enable_gqa=True),
                  per_row=True, main=entry, kernel_main=entry,
                  **routed(GQA_PREFILL_ROUTES, route,
                           lambda: PA.gqa_prefill_launcher(
                               *args, window=window, kernel="first")))
        del k, v, kg, vg
        torch.cuda.empty_cache()



# ----------------------------------------------------------------- parity

PARITY_TOL = 1e-4  # float32 weights: row error as a share of the largest logit
POOL_TOL = 2e-5  # float32 weights: KV pool error as a share of the largest entry
NEAR_TIE = 5e-2  # W4A8 weights: top-2 gap below which greedy tokens may differ
# the engine's model step with the single-user routes forced on it may
# leave the single-user step by this many times what bf16 rounding moves
# the single-user step itself (reroute_check)
SPREAD_FACTOR = 2.0
# weights of one format through the quant_matmul kernels (no activation
# requant): row error as a share of the largest logit, as for ``dense``
FORMAT_TOL = 1e-4
# prompt tokens of a parity model's prefill where not 64: DeepSeek-V3's is
# few tokens (its routed experts then take the gathered path, whose plain
# version reads only the routed experts on the host)
PARITY_PROMPT = {"v3_w4a8": 8}
# decode steps after each parity prefill: each is a full-width CPU forward,
# and a third or fourth step would repeat what the first two hold
PARITY_DECODE = 2


def card_drawn(spec, prepare: bool = True, seed: int = 5, **kw):
    """init_params_synthetic(spec, seed, **kw) drawn on the card (the host
    took 7-9 s for each full-width 2-layer model, the parity phase's
    largest cost), prepared there (prepare_params) where ``prepare``, and
    copied to the host: a parity variant's CPU params, the same bits on
    both devices."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.utils.device_prep import (
        params_to,
        prepare_params,
    )

    params = init_params_synthetic(spec, seed=seed, device="cuda", **kw)
    if prepare:
        params = prepare_params(params, spec)
    cpu = params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    return cpu


def parity_variants():
    """(name, spec, prepared CPU params, tolerance) of the two parity
    models, both DeepSeek-V2-Lite at full width cut to 2 layers:
    - ``dense``: both layers dense, unquantized float32 weights. No int8
      activation code and no router that rounding order could flip, so the
      card (paged-attention and MLA kernels, page writes, rope positions,
      lengths) is held to the CPU within PARITY_TOL on every row;
    - ``w4a8``: one dense and one MoE layer, int4_g weights repacked for
      W4A8, through every W4A8 kernel. Float32 sums in another order flip
      int8 activation codes and now and then swap two nearly tied experts,
      so logits are only recorded and the greedy tokens held (tolerance
      None)."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    cfg = dict(bench_model_cfg(), num_hidden_layers=2)
    dense = spec_from_hf_config(dict(cfg, first_k_dense_replace=2))
    yield "dense", dense, card_drawn(dense, quant="bf16",
                                     dtype=torch.float32), PARITY_TOL
    w4a8 = spec_from_hf_config(cfg)
    yield "w4a8", w4a8, card_drawn(w4a8), None


def format_variant(kind: str):
    """The ``w4a8``-shaped parity model (one dense, one MoE layer, full
    width) with every weight in ``kind``, not repacked (KT_W4A8=0, the
    reference's own switch), so that each matmul runs through the
    quant_matmul kernels: (name, spec, prepared CPU params, FORMAT_TOL)."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    old = os.environ.get("KT_W4A8")
    os.environ["KT_W4A8"] = "0"
    try:
        params = card_drawn(spec, quant=kind)
    finally:
        if old is None:
            del os.environ["KT_W4A8"]
        else:
            os.environ["KT_W4A8"] = old
    return kind, spec, params, FORMAT_TOL


def gqa_variant(name: str, cfg: dict):
    """The model of ``cfg`` (Mixtral-8x7B, Qwen3-30B-A3B, Qwen2-57B-A14B)
    at full width cut to 2 layers with the served weight kinds (int8
    attention, shared expert and lm_head, int4_g experts repacked for
    W4A8): (name, spec, prepared CPU params, None), held by moe_parity.
    The experts run through the W4A8 kernels the route picks, attention
    through the GQA paged kernels."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(dict(cfg, num_hidden_layers=2))
    return name, spec, card_drawn(spec, quant="int8",
                                  moe_quant="int4_g"), None


def hold_rows(out: torch.Tensor, ref: torch.Tensor, what: str, tol) -> dict:
    """The one rule of the parity phases, for logits rows out [N, V]
    against ref [N, V] (float32, CPU): all finite; with a tolerance (the
    float32 weights) every row within tol of the row's largest logit; and
    greedy tokens equal wherever ref's two largest logits lie further
    apart than a near-tie (2 * tol, or NEAR_TIE of the largest logit for
    the W4A8 weights, whose row errors are recorded and not held)."""
    top = ref.abs().amax(dim=-1)
    errs = ((out - ref).abs().amax(dim=-1) / top).tolist()
    top2 = torch.topk(ref, 2, dim=-1).values
    gaps = ((top2[:, 0] - top2[:, 1]) / top).tolist()
    differ = (out.argmax(-1) != ref.argmax(-1)).tolist()
    tie = NEAR_TIE if tol is None else 2 * tol
    wrong = [i for i, d in enumerate(differ) if d and gaps[i] >= tie]
    ok = (bool(torch.isfinite(out).all()) and not wrong
          and (tol is None or max(errs) <= tol))
    log(f"{what}: rel_err per row {['%.1e' % e for e in errs]} "
        f"(held to {tol}), greedy differ at "
        f"{[i for i, d in enumerate(differ) if d]} (not a near-tie: {wrong})")
    if not ok:
        raise AssertionError(f"{what} failed: {errs} wrong tokens {wrong}")
    return dict(rel_err=errs, tol=tol, greedy_differ=sum(differ))


def parity_rows(params, spec, device, prompt: int) -> torch.Tensor:
    """Logits rows [5, V] (float32, CPU) of the parity run on ``device``: the
    last position of a ``prompt``-token prefill, then PARITY_DECODE steps on
    fixed tokens, the same on both sides, through the contiguous forward()
    in float32 compute."""
    from ktransformers_tpu_torch.models.model import KVCache, forward
    from ktransformers_tpu_torch.utils.device_prep import params_to

    feed = [t % spec.vocab_size
            for t in (11, 2222, 33333, 44444)[:PARITY_DECODE]]
    params = params_to(params, device)
    cache = KVCache.create(spec, 1, 128, torch.float32, device)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, spec.vocab_size, (1, prompt)), device=device)
    logits, cache = forward(params, spec, toks, cache,
                            compute_dtype=torch.float32,
                            logits_last_only=True)
    outs = [logits[:, -1].float().cpu()]
    for tok in feed:
        logits, cache = forward(
            params, spec, torch.tensor([[tok]], device=device), cache,
            compute_dtype=torch.float32)
        outs.append(logits[:, -1].float().cpu())
    return torch.cat(outs)


def parity_check(result: dict, variants: list) -> None:
    """parity_rows of a 64-token prefill (PARITY_PROMPT gives another
    length) on the CPU (plain versions) and on the card (kernels) for each
    parity model; rows are held by hold_rows. The int8 model runs once more with the fused decode switched
    off (mla_decode_attention): held to the CPU on the same route, and its
    greedy tokens to the fused route's on the card."""
    from ktransformers_tpu_torch.ops import attention

    t0 = time.perf_counter()
    result.setdefault("parity", {})
    for name, spec, params, tol in variants:
        prompt = PARITY_PROMPT.get(name, 64)
        card = parity_rows(params, spec, "cuda", prompt)
        result["parity"][name] = hold_rows(
            card, parity_rows(params, spec, "cpu", prompt),
            f"parity {name} (card vs CPU)", tol)
        if name != "int8":
            continue
        attention.MLA_FUSED = False
        try:
            unfused = parity_rows(params, spec, "cuda", prompt)
            result["parity"]["int8_unfused"] = hold_rows(
                unfused, parity_rows(params, spec, "cpu", prompt),
                "parity int8, fused decode off (card vs CPU)", tol)
        finally:
            attention.MLA_FUSED = True
        result["parity"]["int8_unfused_vs_fused"] = hold_rows(
            unfused, card, "parity int8 (fused off vs on, on the card)", tol)
        if not torch.equal(unfused.argmax(-1), card.argmax(-1)):
            raise AssertionError("fused-off greedy tokens leave the fused "
                                 "route's")
    result["parity"]["seconds"] = (result["parity"].get("seconds", 0.0)
                                   + time.perf_counter() - t0)


PENALTIES = dict(repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.25)
# the penalty check's model: DeepSeek-V2 cut to 2 dense layers and 4 heads
# at narrow widths with a vocabulary of 512, where greedy decoding repeats
# tokens (at full width 16 greedy tokens of 102,400 need not repeat, and
# then no penalty changes one); the MLA widths stay those the decode kernel
# takes (kv_lora 512, rope 64)
PENALTY_WIDTHS = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, first_k_dense_replace=2, num_attention_heads=4,
    num_key_value_heads=4)


def penalty_check(result: dict) -> None:
    """Greedy generation with repetition, presence and frequency penalties
    through the single-user Generator on the card and on the CPU
    (PENALTY_WIDTHS, unquantized float32 weights, float32 compute, a
    64-token seeded prompt, 16 new tokens): the card's tokens must equal
    the CPU's, and differ from the unpenalized ones (so that the penalties
    were applied)."""
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.engine.sampler import SamplingConfig
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.utils.device_prep import params_to

    spec = spec_from_hf_config(dict(bench_model_cfg(), **PENALTY_WIDTHS))
    prompt = np.random.default_rng(8).integers(0, spec.vocab_size,
                                               64).tolist()
    pen = GenerateConfig(max_new_tokens=16, prefill_chunk=64,
                         sampling=SamplingConfig(**PENALTIES))
    # the same weights on both devices: drawn on the CPU, then copied
    params = init_params_synthetic(spec, seed=5, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    toks = {}
    for dev in ("cpu", "cuda"):
        gen = Generator(params_to(params, dev), spec, max_len=128,
                        cache_dtype=torch.float32,
                        compute_dtype=torch.float32, device=dev)
        toks[dev] = gen.generate(prompt, pen)[0]
    plain = gen.generate(prompt, GenerateConfig(max_new_tokens=16,
                                                prefill_chunk=64))[0]
    del gen, params
    out = dict(penalties=PENALTIES, card=toks["cuda"], cpu=toks["cpu"],
               unpenalized_card=plain)
    result["penalties"] = out
    log(f"penalties (greedy, 2 narrow layers): card {toks['cuda']} cpu "
        f"{toks['cpu']} unpenalized {plain}")
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("penalized tokens differ between card and CPU")
    if plain == toks["cuda"]:
        raise AssertionError("the penalties changed no token")


def pool_err(pools, ref_pools) -> float:
    """Largest error of the KV pools (trash page 0 excluded) as a share of
    the largest entry."""
    return max(rel_err(a[1:].cpu(), b[1:].cpu())[1]
               for a, b in zip(pools, ref_pools))


def paged_parity_check(result: dict, variants: list) -> None:
    """Both parity models through the paged forward: two sequences on
    shuffled page tables, two chunks each (the second sequence's first
    chunk padded), then PARITY_DECODE steps on fixed tokens, on the CPU (plain
    versions) and on the card (kernels), float32. Then, on the card,
    forward_paged_mixed against separate decode and prefill calls. Logits
    rows are held by hold_rows; on the float32 weights the KV pools (every
    layer, every page but the trash page) are held within POOL_TOL too."""
    from ktransformers_tpu_torch.cache.paged import PagedKVCache
    from ktransformers_tpu_torch.models.paged import (
        forward_paged,
        forward_paged_mixed,
    )
    from ktransformers_tpu_torch.utils.device_prep import params_to

    page, pmax, n_pages = 64, 4, 24
    f32 = dict(compute_dtype=torch.float32)

    def inputs(vocab):
        """Prompt tokens, shuffled page tables and decode feed, seeded."""
        rng = np.random.default_rng(4)
        toks = rng.integers(0, vocab, (2, 96))
        tables = (rng.permutation(n_pages - 1)[:16] + 1).reshape(4, pmax)
        return toks, tables, rng.integers(0, vocab, (4, 2))

    def ti(a, device, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def run(cpu_params, spec, device):
        toks, tables, feed = inputs(spec.vocab_size)
        params = params_to(cpu_params, device)
        kv = PagedKVCache.create(spec, n_pages, page, dtype=torch.float32,
                                 device=device)
        pt = ti(tables[:2], device)
        lengths = np.zeros(2, np.int64)
        outs = []
        steps = [(toks[:, :64], [64, 40]), (toks[:, 64:], [32, 32])]
        steps += [(feed[i][:, None], None) for i in range(PARITY_DECODE)]
        for t, valid in steps:
            logits, kv = forward_paged(
                params, spec, ti(t, device, torch.int64), kv, pt,
                ti(lengths, device),
                valid=None if valid is None else ti(valid, device), **f32)
            outs.append(logits[:, -1].float().cpu())
            lengths = lengths + (1 if valid is None else np.asarray(valid))
        return torch.cat(outs), params, kv, lengths

    def check_pools(what, kv, ref, tol) -> float:
        err = pool_err(kv.bufs_a + kv.bufs_b, ref.bufs_a + ref.bufs_b)
        log(f"{what}: kv pools rel_err {err:.3e} (held to "
            f"{None if tol is None else POOL_TOL})")
        if tol is not None and not err <= POOL_TOL:
            raise AssertionError(f"{what}: kv pools differ by {err}")
        return err

    def one(name, spec, cpu_params, tol) -> dict:
        cpu, _, cpu_kv, _ = run(cpu_params, spec, "cpu")
        gpu, params, kv, lengths = run(cpu_params, spec, "cuda")
        what = f"paged parity {name} (card vs CPU)"
        across = hold_rows(gpu, cpu, what, tol)
        across["kv_rel_err"] = check_pools(what, kv, cpu_kv, tol)

        # mixed against separate, on the card: 2 decode rows continue the
        # sequences above, 2 chunks (one padded) start on fresh pages
        toks, tables, feed = inputs(spec.vocab_size)
        dev = "cuda"
        dec_tok = ti(feed[0], dev, torch.int64)
        pre_tok = ti(toks[:, :64], dev, torch.int64)
        dec_pt, pre_pt = ti(tables[:2], dev), ti(tables[2:], dev)
        dec_len, pre_len = ti(lengths, dev), ti([0, 0], dev)
        pre_valid = ti([64, 50], dev)
        kv2 = PagedKVCache(bufs_a=[b.clone() for b in kv.bufs_a],
                           bufs_b=[b.clone() for b in kv.bufs_b],
                           page_size=page)
        dref, _ = forward_paged(params, spec, dec_tok[:, None], kv, dec_pt,
                                dec_len, **f32)
        pref, _ = forward_paged(params, spec, pre_tok, kv, pre_pt, pre_len,
                                valid=pre_valid, **f32)
        dout, pout, _ = forward_paged_mixed(
            params, spec, dec_tok, pre_tok, kv2, dec_pt, dec_len, pre_pt,
            pre_len, pre_valid, **f32)
        torch.cuda.synchronize()
        what = f"paged parity {name} (mixed vs separate on the card)"
        mixed = hold_rows(torch.cat([dout, pout]).float().cpu(),
                          torch.cat([dref[:, -1], pref[:, -1]]).float().cpu(),
                          what, tol)
        mixed["kv_rel_err"] = check_pools(what, kv2, kv, tol)
        return dict(card_vs_cpu=across, mixed_vs_separate=mixed)

    t0 = time.perf_counter()
    result.setdefault("paged_parity", {})
    for name, spec, cpu_params, tol in variants:
        result["paged_parity"][name] = one(name, spec, cpu_params, tol)
        torch.cuda.empty_cache()
    result["paged_parity"]["seconds"] = (
        result["paged_parity"].get("seconds", 0.0) + time.perf_counter() - t0)


# ------------------------------------------------------------------ serve


SINGLE_USER_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "gathered_w4a8_ffn",
                       "dense_w4a8_ffn", "grouped_w4a8_ffn",
                       "mla_decode_fused")
INT8_SINGLE_USER_KERNELS = ("quant_matmul", "gathered_quant_matmul",
                            "grouped_quant_matmul", "mla_decode_fused",
                            "mla_decode_attention")


# the warm-up prompt of a Generator: three 256-token chunks, so the chunk's
# prefill step is captured (WARMUP eager calls, then the capture) before a
# timed request
WARM_CHUNKS = 3


def warm_generator(gen) -> None:
    """A warm-up request (allocator, cuBLAS handles, the 256-token chunk's
    prefill step and the greedy decode step warmed up and captured) under
    the current ops.attention switches; not counted."""
    from ktransformers_tpu_torch.engine.cuda_graph import WARMUP
    from ktransformers_tpu_torch.engine.generate import GenerateConfig

    n = min(WARM_CHUNKS * 256, min(gen.max_len, gen.spec.rope.max_position)
            - WARMUP - 3)
    gen.generate([t % gen.spec.vocab_size for t in range(n)],
                 GenerateConfig(max_new_tokens=WARMUP + 3))


def timed_generate(gen, prompt: list, cfg) -> tuple:
    """gen.generate of one prompt: (tokens, ttft s, decode tok/s). The
    pipeline resolves tokens in bunches, so ttft is the first token's
    resolution on the host's clock and the decode rate runs from it to a
    final synchronize."""
    stamps = []
    t_start = time.perf_counter()
    out = gen.generate(prompt, cfg, on_token=lambda tok: stamps.append(
        time.perf_counter()))[0]
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return out, stamps[0] - t_start, (len(out) - 1) / (t_end - stamps[0])


def eager_greedy(gen, prompt: list, n: int, chunk: int = 256) -> list:
    """n greedy tokens of the eager loop: gen.prefill in ``chunk``-token
    chunks, then gen.decode_step a token at a time, on a cache of its own
    (no graph)."""
    from ktransformers_tpu_torch.engine.sampler import SamplingConfig, sample

    cache = gen.new_cache()
    last, cache = gen.prefill(
        cache, torch.as_tensor([prompt], device=gen.device), chunk)
    tok = sample(last, None, SamplingConfig())
    out = [int(tok[0])]
    while len(out) < n:
        tok, cache = gen.decode_step(tok, cache)
        out.append(int(tok[0]))
    return out


def hold_graphed(what: str, gen, prompt: list, got: list,
                 chunk: int = 256) -> None:
    """The graphed Generator's greedy tokens ``got`` against the eager
    loop's on the same prompt, token for token (the same kernels on the
    same operands), its greedy decode step and the 256-token chunk's
    prefill step captured."""
    from ktransformers_tpu_torch.engine.sampler import SamplingConfig

    if not gen.decode_graph(SamplingConfig()).graphed:
        raise AssertionError(f"{what}: the decode step was not captured")
    if not gen.prefill_graph(256).graphed:
        raise AssertionError(f"{what}: the 256-token prefill step was not "
                             "captured")
    want = eager_greedy(gen, prompt, len(got), chunk)
    if got != want:
        raise AssertionError(f"{what}: graphed tokens {got} != eager {want}")


def scratch_growth_check(gen, prompt: list, want: list) -> dict:
    """The scratch hazard of a captured step: after the capture every
    split kernel's scratch set is asked for twice its size, as a call
    twice as wide asks (w4a8_matmul.scratch replaces the set), NaN and
    non-zero counter tensors of the replaced sets' sizes take the memory a
    freed set would give back, and the graphed generate of ``prompt`` must still give ``want``,
    the eager loop's tokens."""
    from ktransformers_tpu_torch.engine.generate import GenerateConfig
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul

    sets = dict(w4a8_matmul._SCRATCH)
    for (dev, what), (part, cnt) in sets.items():
        w4a8_matmul.scratch(dev, 2 * part.numel(), 2 * cnt.numel(), what)
    grown = sorted(k[1] for k, buf in sets.items()
                   if w4a8_matmul._SCRATCH[k] is not buf)
    if not grown:
        raise AssertionError("scratch growth: no set was replaced")
    sizes = [(part.numel(), cnt.numel()) for part, cnt in sets.values()]
    del sets, part, cnt
    torch.cuda.synchronize()
    junk = [(torch.full((n,), float("nan"), device=gen.device),
             torch.full((c,), 7, dtype=torch.int32, device=gen.device))
            for n, c in sizes]
    got = gen.generate(prompt, GenerateConfig(max_new_tokens=len(want)))[0]
    del junk
    if got != want:
        raise AssertionError(f"scratch growth: replayed {got} != {want}")
    log(f"scratch growth: sets {grown} replaced after the capture; the "
        "replay gave the eager tokens")
    return dict(grown=grown, tokens_equal=True)


def sampled_repeat_check(gen, prompt: list) -> dict:
    """A sampled run (temperature 0.7, top-p 0.9, seed 7) through the
    graphed step twice: the first warms up and captures it, the second
    only replays; the tokens repeat token for token. Seed 8 is recorded
    beside them."""
    import dataclasses

    from ktransformers_tpu_torch.engine.generate import GenerateConfig
    from ktransformers_tpu_torch.engine.sampler import SamplingConfig

    cfg = GenerateConfig(max_new_tokens=32, seed=7, sampling=SamplingConfig(
        temperature=0.7, top_p=0.9))
    first = gen.generate(prompt, cfg)[0]
    again = gen.generate(prompt, cfg)[0]
    other = gen.generate(prompt, dataclasses.replace(cfg, seed=8))[0]
    if not gen.decode_graph(cfg.sampling).graphed or first != again:
        raise AssertionError(f"sampled run: {first} then {again}")
    log(f"sampled run (seed 7) repeats: {first[:8]}...; seed 8 "
        f"{'differs' if other != first else 'gives the same'}")
    return dict(tokens=first, seed8=other)


def serve(result: dict, quant: str = "int4_g", key: str = "serve",
          requests: int = 2, expect=SINGLE_USER_KERNELS,
          unfused_last: bool = False, cfg=None, moe_quant=None,
          max_len: int = 1024, prompt_lens=None, checks: bool = False):
    """A Generator over the full config (DeepSeek-V2-Lite unless ``cfg``
    names another) with ``quant`` weights (``moe_quant`` for the routed
    experts, default the same) at ``max_len`` cache positions answering
    ``requests`` requests of 512 (or ``prompt_lens``) + 32 tokens through
    its graphed prefill and decode steps, each request's tokens held to
    the eager loop's; with unfused_last the last one decodes with the
    fused decode kernel switched off. With ``checks`` also the scratch growth and the
    sampled repeat (scratch_growth_check, sampled_repeat_check)."""
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops import attention
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )

    cfg = cfg or bench_model_cfg()
    spec = spec_from_hf_config(cfg)
    t0 = time.perf_counter()
    params = init_params_synthetic(spec, seed=0, quant=quant,
                                   moe_quant=moe_quant or quant,
                                   device="cuda")
    gen = Generator(params, spec, max_len=max_len, batch=1, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = 0
    for obj in _leaves(gen.params):
        pbytes += obj.numel() * obj.element_size()
    log(f"{key}: {cfg['model_type']} {quant} / {moe_quant or quant} params "
        f"{pbytes / 1e9:.3f} GB ready in {init_s:.1f} s")

    # warm-up requests (warm_generator), with the fused decode off too
    # where a request takes it
    for fused in (True, False) if unfused_last else (True,):
        attention.MLA_FUSED = fused
        try:
            warm_generator(gen)
        finally:
            attention.MLA_FUSED = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs, prompts = [], []
    lens = prompt_lens or [512] * requests
    for i, n in enumerate(lens):
        prompt = np.random.default_rng(100 + i).integers(
            0, cfg["vocab_size"], n).tolist()
        fused = not (unfused_last and i == len(lens) - 1)
        attention.MLA_FUSED = fused
        try:
            toks, ttft, dec = timed_generate(
                gen, prompt, GenerateConfig(max_new_tokens=32))
        finally:
            attention.MLA_FUSED = True
        if len(toks) != 32 or not all(0 <= t < cfg["vocab_size"]
                                      for t in toks):
            raise AssertionError(f"request {i}: bad tokens {toks}")
        prompts.append((prompt, toks, fused))
        reqs.append(dict(prompt_tokens=n, prefill_tok_s=n / ttft,
                         ttft_s=ttft, decode_tok_s=dec, tokens=toks[:8],
                         fused_decode=fused))
        log(f"{key} request {i}: {n} prompt tokens, prefill "
            f"{n / ttft:.1f} tok/s "
            f"(ttft {ttft * 1e3:.1f} ms), decode {dec:.2f} tok/s"
            f"{'' if fused else ' (fused decode off)'}")
    launches = dict(LAUNCHES)
    routed_n = dict(ROUTED_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the graphed step's tokens against the eager loop's, each request
    # under its own fused-decode switch
    for i, (prompt, toks, fused) in enumerate(prompts):
        attention.MLA_FUSED = fused
        try:
            hold_graphed(f"{key} request {i}", gen, prompt, toks)
        finally:
            attention.MLA_FUSED = True
    result[key] = dict(model=cfg["model_type"], quant=quant,
                       moe_quant=moe_quant or quant, requests=reqs,
                       launches=launches, routed_launches=routed_n,
                       max_memory_allocated=peak,
                       params_bytes=pbytes, init_s=init_s,
                       graphed_equals_eager=len(prompts))
    log(f"{key}: max_memory_allocated {peak / 1e9:.3f} GB, launches "
        f"{json.dumps(launches)}, of them on the redesigned kernels "
        f"{json.dumps(routed_n)}; the graphed tokens of {len(prompts)} "
        "requests equal the eager loop's")
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {key} run: "
                             f"{missing}")
    if checks:
        prompt, toks, _ = prompts[0]
        result[key]["scratch_growth"] = scratch_growth_check(gen, prompt,
                                                             toks)
        result[key]["sampled"] = sampled_repeat_check(gen, prompt)
    return gen


def step_launches(result: dict, gen, key: str, want: dict) -> dict:
    """Launches of one 256-token prefill chunk and one decode step (with
    an MLA model also one with the fused decode off), held to ``want``,
    the counts the code implies; returns the redesigned kernels' launches
    of each (ROUTED_LAUNCHES)."""
    from ktransformers_tpu_torch.ops import attention
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )

    prompt = torch.as_tensor(np.random.default_rng(201).integers(
        0, gen.spec.vocab_size, (1, 256)), device=gen.device)
    routed_n: dict = {}

    def counts(fn) -> dict:
        reset_launches()
        fn()
        torch.cuda.synchronize()
        routed_n[len(routed_n)] = {k: v for k, v in ROUTED_LAUNCHES.items()
                                   if v}
        return {k: v for k, v in LAUNCHES.items() if v}

    cache = gen.new_cache()
    state = {}

    def chunk():
        state["last"], _ = gen.prefill(cache, prompt)

    got = {"prefill_chunk": counts(chunk)}
    tok = state["last"].argmax(-1)
    got["decode_step"] = counts(lambda: gen.decode_step(tok, cache))
    if "decode_step_unfused" in want:
        attention.MLA_FUSED = False
        try:
            got["decode_step_unfused"] = counts(
                lambda: gen.decode_step(tok, cache))
        finally:
            attention.MLA_FUSED = True
    routed_by = dict(zip(got, routed_n.values()))
    log(f"{key}: {json.dumps(got)}; on the redesigned kernels "
        f"{json.dumps(routed_by)}")
    result[key] = got
    result[key + "_routed"] = routed_by
    if got != want:
        raise AssertionError(f"{key}: {got}, want {want}")
    return routed_by


# DeepSeek-V2-Lite on int8 weights at INT8_LAYERS of its 27 layers (all 27
# until the speculation and sparse_serve phases took the time): the dense
# layer 0 and 8 MoE layers
INT8_LAYERS = 9


def int8_step_launches(result: dict, gen) -> None:
    """On the int8 parameters of L layers: quant_matmul 4 L + 1 (qkv_a and
    o_proj in every layer, lm_head, and gate_up + down of the dense /
    shared MLPs), the expert kernel 2 (L - 1) (gathered at decode, grouped
    at prefill), the attention kernel L at decode (prefill attention is
    plain PyTorch) and no W4A8 kernel; with the fused decode off, every
    one of the L bf16 mla_decode_attention calls on
    mla_decode_split_kernel<false>."""
    n = gen.spec.num_layers
    routed_by = step_launches(result, gen, "int8_step_launches", {
        "prefill_chunk": {"quant_matmul": 4 * n + 1,
                          "grouped_quant_matmul": 2 * (n - 1)},
        "decode_step": {"quant_matmul": 4 * n + 1,
                        "gathered_quant_matmul": 2 * (n - 1),
                        "mla_decode_fused": n},
        "decode_step_unfused": {"quant_matmul": 4 * n + 1,
                                "gathered_quant_matmul": 2 * (n - 1),
                                "mla_decode_attention": n},
    })
    split = routed_by["decode_step_unfused"].get(
        "mla_decode_split_kernel<false>", 0)
    if split != n:
        raise AssertionError(f"fused decode off: {split} of {n} attention "
                             "calls on mla_decode_split_kernel<false>")


# Mixtral-8x7B served at MIXTRAL_LAYERS of its 32 layers (served whole
# until the SmallThinker / Qwen3-Next phase took the time, at 16 until the
# host-offload phase did)
MIXTRAL_LAYERS = 8
_LM = MIXTRAL_LAYERS
# Mixtral, L layers: quant_matmul 2 L + 1 (the fused qkv and o_proj of
# every layer, lm_head), the expert matmul 2 L (gathered at decode on the
# GEMV, which quantizes x itself; grouped at prefill, 512 rows, past the
# tensor-core kernel's fold crossover: one activation prep each; Mixtral's
# experts are too wide for the fused FFN), GQA attention plain PyTorch on
# the contiguous cache
MIXTRAL_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 2 * _LM + 1,
                      "grouped_w4a8_matmul": 2 * _LM, "w4a8_prep": 2 * _LM},
    "decode_step": {"quant_matmul": 2 * _LM + 1,
                    "gathered_w4a8_matmul": 2 * _LM},
}
# ... and on the paged path the GQA kernel once a layer: a decode batch of
# 8 (16 gathered rows: a GEMV block of two rows would quantize more groups
# than w4a8_matmul.gemv_folds lets it, so a prep each), and a mixed step (8
# decode rows + one 256-token chunk: 528 grouped rows, a prep each)
MIXTRAL_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 2 * _LM + 1,
                             "gathered_w4a8_matmul": 2 * _LM,
                             "w4a8_prep": 2 * _LM, "gqa_paged_decode": _LM},
    "serve_mixed_step_b8_s256": {"quant_matmul": 2 * _LM + 1,
                                 "grouped_w4a8_matmul": 2 * _LM,
                                 "w4a8_prep": 2 * _LM,
                                 "gqa_paged_decode": _LM,
                                 "gqa_paged_prefill": _LM},
}


# ------------------------------------------------------------ paged serve

PAGED_PROMPT_LENS = (512, 384, 256, 128, 512, 320, 64, 448)
PAGED_NEW_TOKENS = 32
PAGED_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "gathered_w4a8_ffn",
                 "dense_w4a8_ffn", "grouped_w4a8_ffn", "mla_paged_decode",
                 "mla_paged_prefill")
INT8_PAGED_KERNELS = ("quant_matmul", "gathered_quant_matmul",
                      "grouped_quant_matmul", "mla_paged_decode",
                      "mla_paged_prefill")
MIXTRAL_SINGLE_USER_KERNELS = ("w4a8_prep", "quant_matmul",
                               "gathered_w4a8_matmul", "grouped_w4a8_matmul")
MIXTRAL_PAGED_KERNELS = MIXTRAL_SINGLE_USER_KERNELS + ("gqa_paged_decode",
                                                       "gqa_paged_prefill")


def paged_prompts(vocab: int) -> list:
    """Eight seeded prompts; request 4 repeats the first 256 tokens of
    request 0 (four full pages), so the prefix cache must hit."""
    prompts = [np.random.default_rng(300 + i).integers(0, vocab, n).tolist()
               for i, n in enumerate(PAGED_PROMPT_LENS)]
    prompts[4][:256] = prompts[0][:256]
    return prompts


def greedy_decode(gen, last, cache, n: int):
    """n greedy tokens of the single-user Generator from the last logits
    row ``last`` [1, V] of a prefilled ``cache`` and, per position, the gap
    between its two largest logits as a share of the largest logit
    magnitude (a small gap marks a bf16 near-tie)."""
    toks, gaps = [], []
    for _ in range(n):
        lf = last.float()
        top2 = torch.topk(lf[0], 2).values
        gaps.append(float((top2[0] - top2[1]) / lf.abs().max()))
        tok = lf.argmax(-1)
        toks.append(int(tok[0]))
        if len(toks) < n:
            logits, cache = gen._forward(tok[:, None], cache)
            last = logits[:, -1]
    return toks, gaps


def single_user_reference(gen, prompt: list, n: int):
    """greedy_decode of n tokens after the prompt's 256-token prefill."""
    cache = gen.new_cache()
    last, cache = gen.prefill(
        cache, torch.as_tensor([prompt], device=gen.device), 256)
    return greedy_decode(gen, last, cache, n)


def paged_serve_run(gen, prompts, depth: int, expect=PAGED_KERNELS,
                    sched=None, graphs: bool = True) -> dict:
    """The 8 requests through one ServeEngine (``sched``, default
    SchedulerConfig()) in three waves: 0-3 at once, 5 and 6 after 8 engine
    steps, 4 and 7 once request 0 has finished (request 4 then takes
    request 0's slot). A hybrid model (linear-attention layers) runs
    no prefix cache and no fused mixed step, and zeroes a slot's state
    before each query's first chunk: held instead of the prefix hit and
    the mixed steps, with request 4's reused slot among the zeroed ones.
    The decode step is captured and replayed (it must be), or with
    ``graphs`` False runs eagerly (ServeEngine.graph_steps)."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
    from ktransformers_tpu_torch.utils.observability import StageTimer

    num_pages = 512
    eng = ServeEngine(gen.params, gen.spec, sched or SchedulerConfig(),
                      num_pages=num_pages, device="cuda")
    eng.decode_pipeline_depth = depth
    eng.graph_steps = graphs
    eng.generate_sync(list(range(8)), max_new_tokens=2)  # warm-up
    eng.reset_metrics()
    resets, hybrid = [], gen.spec.hybrid
    if hybrid:
        reset = eng._reset_linear_state

        def counted_reset(slot):
            resets.append(slot)
            reset(slot)

        eng._reset_linear_state = counted_reset
    eng.timer = StageTimer(enabled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    qs: dict = {}

    def submit(*ids):
        for i in ids:
            qs[i] = eng.submit(prompts[i], max_new_tokens=PAGED_NEW_TOKENS)

    submit(0, 1, 2, 3)
    steps = 0
    while len(qs) < 8 or any(q.state != "done" for q in qs.values()):
        if not eng.step() and len(qs) == 8:
            break
        steps += 1
        if steps == 8:
            submit(5, 6)
        if 4 not in qs and qs[0].state == "done":
            submit(4, 7)
        if steps > 2000:
            raise AssertionError("paged serve did not finish")
    while eng.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    routed_n = dict(ROUTED_LAUNCHES)
    held = 0 if eng.prefix is None else eng.prefix.stats()["nodes"]
    out = dict(
        depth=depth, wall_s=wall, engine_steps=eng.steps_executed,
        mixed_steps_fused=eng.mixed_steps_fused,
        output_tok_s=8 * PAGED_NEW_TOKENS / wall,
        tokens=[list(qs[i].output_ids) for i in range(8)],
        finish=[qs[i].finish_reason for i in range(8)],
        ttft_s=[qs[i].ttft for i in range(8)],
        tbt_s=[qs[i].tbt for i in range(8)],
        matched_len=[qs[i].matched_len for i in range(8)],
        preemptions=sum(qs[i].preemptions for i in range(8)),
        free_pages=eng.alloc.free_count, prefix_pages=held,
        stage_timer=eng.timer.report(), launches=launches,
        routed_launches=routed_n,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        kv_pool_bytes=eng.kv.bytes_per_page() * num_pages,
        state_bytes=eng.kv.state_bytes(), state_resets=resets,
        graphs_captured=eng._graphs.captured(),
        graphs_by_kind={k: eng._graphs.captured(k)
                        for k in ("prefill", "mixed")},
        graph_pool_bytes=eng._graphs.pool_bytes(),
    )
    log(f"paged serve depth {depth}: {steps} engine steps "
        f"({eng.mixed_steps_fused} fused mixed) in {wall:.2f} s, "
        f"{out['output_tok_s']:.1f} output tok/s; ttft ms "
        f"{[round(t * 1e3) for t in out['ttft_s']]}; mean tbt ms "
        f"{[round(t * 1e3, 1) for t in out['tbt_s']]}; matched "
        f"{out['matched_len']}; stages {json.dumps(out['stage_timer'])}; "
        f"max_memory_allocated {out['max_memory_allocated'] / 1e9:.3f} GB; "
        f"captured {out['graphs_captured']} steps "
        f"({json.dumps(out['graphs_by_kind'])}), graph pools "
        f"{json.dumps(out['graph_pool_bytes'])} bytes")
    vocab = gen.spec.vocab_size
    for i in range(8):
        t = out["tokens"][i]
        if (out["finish"][i] != "length" or len(t) != PAGED_NEW_TOKENS
                or not all(0 <= x < vocab for x in t)):
            raise AssertionError(f"paged request {i}: {out['finish'][i]} {t}")
    if hybrid:
        if eng.mixed_steps_fused or eng.prefix is not None or any(
                out["matched_len"]):
            raise AssertionError("hybrid engine: a fused mixed step or a "
                                 "prefix hit ran")
        if len(resets) != 8 or len(set(resets)) == len(resets):
            raise AssertionError(f"hybrid engine: slot states zeroed at "
                                 f"{resets}, want 8 with a reused slot")
    elif eng.mixed_steps_fused < 1:
        raise AssertionError("no fused mixed step ran")
    elif out["matched_len"][4] != 256:
        raise AssertionError(f"request 4 matched {out['matched_len'][4]}")
    if out["free_pages"] + held != num_pages - 1:
        raise AssertionError(
            f"pages leaked: {out['free_pages']} free + {held} cached")
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by paged serve: {missing}")
    if graphs != bool(out["graphs_captured"]):
        raise AssertionError(f"paged serve: {out['graphs_captured']} "
                             f"steps captured, graph_steps {graphs}")
    return out


def forced_weights(logits, cfg, idx):
    """ops/gate.route's weights for the experts ``idx`` [T, k] instead of
    its own top-k: their scores, renormalized and scaled as route does."""
    logits = logits.to(torch.float32)
    scores = (torch.softmax(logits, dim=-1) if cfg.scoring == "softmax"
              else torch.sigmoid(logits))
    w = torch.gather(scores, 1, idx.long())
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor


def model_steps(gen, prompt: list, toks: list, paged: bool = False,
                forced=None):
    """The single-user forward, or with ``paged`` the engine's model step
    (forward_paged, one sequence), fed ``prompt`` in 256-token chunks and
    then ``toks`` one a step: (logits [steps, V], float32, each step's last
    row; routes, a list a step of the [T, k] experts each router call of
    the step picked). With ``forced`` (such routes from the other side)
    every router call takes the forced call's experts, weighted by its own
    scores (forced_weights): the two sides then differ by rounding
    alone."""
    from ktransformers_tpu_torch.cache.paged import PagedKVCache
    from ktransformers_tpu_torch.models import model
    from ktransformers_tpu_torch.models.paged import forward_paged

    dev, spec = gen.device, gen.spec
    n = len(prompt)
    seq = torch.as_tensor([prompt + toks], device=dev)
    ends = [min(n, i + 256) for i in range(0, n, 256)]
    ends += list(range(n + 1, n + len(toks) + 1))
    if paged:
        pages = -(-seq.shape[1] // 64)
        kv = PagedKVCache.create(spec, pages + 1, 64, dtype=gen.cache_dtype,
                                 device=dev)
        tables = torch.arange(1, pages + 1, dtype=torch.int32,
                              device=dev)[None]

        def step(start, end):
            return forward_paged(
                gen.params, spec, seq[:, start:end], kv, tables,
                torch.tensor([start], dtype=torch.int32, device=dev),
                rope_tables=gen.rope_tables,
                compute_dtype=gen.compute_dtype)[0]
    else:
        cache = gen.new_cache()

        def step(start, end):
            return gen._forward(seq[:, start:end], cache, True)[0]

    route, feed = model.route, iter([i for s in forced or () for i in s])
    logits, routes = [], []

    def hooked(lg, cfg, bias=None):
        if forced is None:
            idx, w = route(lg, cfg, bias)
        else:
            idx = next(feed)
            w = forced_weights(lg, cfg, idx)
        routes[-1].append(idx)
        return idx, w

    model.route = hooked
    try:
        start = 0
        for end in ends:
            routes.append([])
            logits.append(step(start, end)[:, -1].float())
            start = end
    finally:
        model.route = route
    return torch.cat(logits), routes


def expert_sets(calls) -> list:
    return [[frozenset(r) for r in idx.tolist()] for idx in calls]


def reroute_check(gen, prompt: list, toks: list, what: str,
                  tol: float | None = None) -> tuple:
    """The engine's model step against the single-user forward, fed the
    same ``prompt`` and then ``toks`` (model_steps):
    - the index of the first token of ``toks`` whose logits follow a step
      where a router call of the two chose other experts for some row (0:
      the prompt's own routes differ), None where no route differs;
    - the engine's model step again with the single-user routes forced on
      it, held by hold_rows at ``tol``: what the routes do not explain (the
      windows, the early router's input, the paged kernels) must stay
      inside it. Without ``tol`` it is SPREAD_FACTOR times the rounding
      spread: the largest row error, against the same single-user steps,
      of the single-user forward in float32 compute under the same routes
      (what bf16 rounding alone moves the single-user step by).
    Returns (that index, a record with the tolerance held)."""
    ref, routes = model_steps(gen, prompt, toks)
    _, paged_routes = model_steps(gen, prompt, toks, paged=True)
    chunks = len(routes) - len(toks)  # the last prompt chunk gives token 0
    first = next((max(0, i - chunks + 1)
                  for i, (a, b) in enumerate(zip(routes, paged_routes))
                  if expert_sets(a) != expert_sets(b)), None)
    spread = None
    if tol is None:
        dtypes = gen.compute_dtype, gen.cache_dtype
        gen.compute_dtype = gen.cache_dtype = torch.float32
        try:
            f32, _ = model_steps(gen, prompt, toks, forced=routes)
        finally:
            gen.compute_dtype, gen.cache_dtype = dtypes
        spread = float(((f32 - ref).abs().amax(-1)
                        / ref.abs().amax(-1)).max())
        tol = SPREAD_FACTOR * spread
    out, _ = model_steps(gen, prompt, toks, paged=True, forced=routes)
    held = hold_rows(out.cpu(), ref.cpu(), f"{what} (single-user routes "
                     "forced on the engine's model step)", tol)
    return first, dict(steps=len(routes), max_rel_err=max(held["rel_err"]),
                       tol=tol, spread=spread,
                       greedy_differ=held["greedy_differ"])


def paged_serve(result: dict, gen, key: str = "paged_serve", depths=(3,),
                expect=PAGED_KERNELS, tie: float = NEAR_TIE, prompts=None,
                sched=None, reroutes: bool = False,
                eager: bool = False) -> None:
    """The 8 requests (paged_prompts unless ``prompts``) through the
    ServeEngine (paged_serve_run) at each pipeline depth, each request's
    tokens held to the single-user Generator's up to the first position
    whose top-2 gap there lies below ``tie`` of the largest logit (a
    near-tie that rounding order may flip). With ``reroutes`` (a model
    whose random weights grow a rounding difference past any near-tie:
    SmallThinker's ReLU experts under unnormalized sigmoid weights) a
    request may leave the single-user tokens elsewhere only after a token
    that the engine's model step and the single-user forward, fed the
    same tokens, send to other experts (reroute_check): moe_parity's
    rule. The engine's model step under the single-user routes must then
    stay within SPREAD_FACTOR times the rounding spread on every step up
    to that token, as must request 0's (the longest prompt) over its
    prompt and first 8 tokens: request 0 measures the spread, every
    request is held to it (reroute_check). With ``eager`` the first depth
    runs once more with every step eager, whose tokens must equal the
    graphed run's token for token, where a mixed step was captured."""
    prompts = prompts or paged_prompts(gen.spec.vocab_size)
    runs = {depth: paged_serve_run(gen, prompts, depth, expect, sched)
            for depth in depths}
    if eager and not runs[depths[0]]["graphs_by_kind"]["mixed"]:
        raise AssertionError(f"{key}: no mixed step was captured")
    if eager:
        ref = paged_serve_run(gen, prompts, depths[0], expect, sched,
                              graphs=False)
        if ref["tokens"] != runs[depths[0]]["tokens"]:
            raise AssertionError(
                f"{key}: graphed engine tokens {runs[depths[0]]['tokens']} "
                f"!= eager {ref['tokens']}")
        log(f"{key}: the graphed engine's tokens equal the eager engine's; "
            f"wall {runs[depths[0]]['wall_s']:.2f} s against "
            f"{ref['wall_s']:.2f} s")
        result[key + "_eager"] = dict(wall_s=ref["wall_s"],
                                      output_tok_s=ref["output_tok_s"],
                                      tokens_equal=True)
    # the single-user Generator on the same prompts
    full, verdicts, firsts, tol, refs = 0, [], set(), None, []
    for i, prompt in enumerate(prompts):
        ref, gaps = single_user_reference(gen, prompt, PAGED_NEW_TOKENS)
        refs.append((ref, gaps))
        firsts.add(ref[0])
        for depth, run in runs.items():
            got = run["tokens"][i]
            diff = next((j for j in range(len(ref)) if got[j] != ref[j]), None)
            wide = diff is not None and gaps[diff] >= tie
            rerouted = forced = None
            if reroutes and (wide or (i == 0 and depth == depths[0])):
                rerouted, forced = reroute_check(
                    gen, prompt, got[:diff] if wide else got[:8],
                    f"{key} request {i}", tol)
                tol = forced["tol"]
            verdicts.append(dict(request=i, depth=depth, first_diff=diff,
                                 gap=None if diff is None else gaps[diff],
                                 first_reroute=rerouted if wide else None,
                                 routes_forced=forced))
            if wide and (rerouted is None or rerouted > diff):
                raise AssertionError(
                    f"paged request {i} (depth {depth}) leaves the "
                    f"single-user tokens at {diff} with a top-2 gap of "
                    f"{gaps[diff]:.3e}: {got} vs {ref}")
        full += all(run["tokens"][i] == ref for run in runs.values())
    first = runs[depths[0]]["tokens"]
    same = all(run["tokens"] == first for run in runs.values())
    distinct = len({t for run in runs.values() for toks in run["tokens"]
                    for t in toks})
    log(f"{key}: {full}/8 requests equal the single-user Generator "
        f"token for token at depth {list(depths)}; the rest first differ at "
        f"a near-tie (top-2 gap < {tie}); tokens equal across depths: "
        f"{same}; {len(firsts)} distinct first tokens, {distinct} distinct "
        "tokens served")
    result[key] = dict(runs=runs, agreement=verdicts, single_user=refs,
                       requests_equal_single_user=full,
                       depths_agree=same,
                       distinct_first_tokens=len(firsts),
                       distinct_tokens=distinct)
    # weights whose outputs ignore the prompt would make the agreement
    # above hold whatever pages, slots or lengths the engine used
    if len(firsts) < 4:
        raise AssertionError(f"{key}: the 8 prompts give {len(firsts)} "
                             "distinct first tokens; the agreement check "
                             "cannot see the prompt")


# ---------------------------------------------------------------- profile


# the base names of the port's kernels (an instantiation's name holds one)
PORT_KERNELS = ("w4a8_rows_kernel", "ffn_up_kernel", "w4a8_mma_kernel",
                "quant_mma_kernel", "w4a8_gemv_kernel", "w4a8_ffn_mma_kernel",
                "w4a8_prep_kernel", "mla_decode_fused_kernel",
                "mla_paged_decode_kernel", "mla_paged_prefill_kernel",
                "quant_rows_kernel", "mla_decode_attention_kernel",
                "gqa_paged_decode_kernel", "gqa_decode_combine_kernel",
                "gqa_paged_prefill_kernel", "quant_rows_t_kernel",
                "quant_gemv_kernel", "quant_wgmma_t_kernel",
                "mla_decode_split_kernel", "mla_prefill_mma_kernel",
                "mla_paged_decode_split_kernel", "gqa_prefill_mma_kernel",
                "w4a8_ffn_gemv_kernel", "gqa_decode_split_kernel",
                "w4a8_prep_block_kernel")


def port_kernel_base(name: str):
    """The base name (PORT_KERNELS) of a port kernel's name, or None."""
    found = [k for k in PORT_KERNELS if k in name]
    return max(found, key=len) if found else None


def _is_port_kernel(name: str) -> bool:
    return port_kernel_base(name) is not None


# first-version instantiations no call of the main paths should take: the
# 8-row tiles on bf16 activations (the tensor-core kernels take every dense
# and grouped bf16 call of 2 rows or more), the one-row tiles of the
# quant_matmul family (the GEMV takes one-row dense and every gathered
# call), the transposed first version (the wgmma kernel takes every SFT
# shape), every W4A8 rows kernel (the W4A8 GEMV takes one-row dense calls,
# gathered calls and the FFN's one-row downs; w4a8_mma_kernel the rest),
# the FFN's gate_up of 1 and 4 rows a tile (w4a8_ffn_gemv_kernel takes
# one-row tiles, w4a8_ffn_mma_kernel tiles of more than one row) and the
# bf16 attention first versions: MLA fused decode, decode attention, paged
# decode and paged prefill, GQA paged decode (and its combine launch) and
# paged prefill (mla_decode_split_kernel<true> / <false>,
# mla_paged_decode_split_kernel, mla_prefill_mma_kernel,
# gqa_decode_split_kernel and gqa_prefill_mma_kernel take every bf16 call);
# a step that launches one of these has a wrapper off its route
_OFF_ROUTE = re.compile(r"quant_rows_kernel<\d+, 8, __nv_bfloat16>"
                        r"|w4a8_rows_kernel<"
                        r"|quant_rows_kernel<\d+, 1, "
                        r"|quant_rows_t_kernel<"
                        r"|ffn_up_kernel<1>"
                        r"|ffn_up_kernel<4>"
                        r"|mla_decode_fused_kernel<__nv_bfloat16>"
                        r"|mla_paged_decode_kernel<__nv_bfloat16>"
                        r"|mla_paged_prefill_kernel<__nv_bfloat16>"
                        r"|gqa_paged_decode_kernel<__nv_bfloat16, "
                        r"|gqa_decode_combine_kernel<__nv_bfloat16, "
                        r"|gqa_paged_prefill_kernel<__nv_bfloat16, "
                        r"|mla_decode_attention_kernel<__nv_bfloat16>")


def off_route(rows) -> list:
    """Names of kernel rows (name, ms, count) that are first-version
    instantiations the routes should have replaced (_OFF_ROUTE)."""
    return [r[0] for r in rows if _OFF_ROUTE.search(r[0])]


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# spin kernels (torch.cuda._sleep, ~0.1 ms each) a profiled call of
# kernel_rows runs between, before and after it: a trace on the H100 loses
# a profile's first device events now and then (21 of a DeepSeek-V3
# chunk's 972, a w4a8_prep and a w4a8_mma among them, in every profile of
# some runs; 20 of the 32 leading spins in a development run; all 32 in 3
# profiles of a decode forward 10 minutes into a run), which are then
# spins; each new profile of a call takes PROFILE_PAD_GROWTH times as many
PROFILE_PAD = 32
PROFILE_PAD_GROWTH = 8
PROFILE_PAD_CYCLES = 200_000
_SPIN = "spin_kernel"
# profiles of a call at most while the trace lost every leading spin
PROFILE_TRIES = 3


def _profile(fn, spins: int) -> tuple:
    """(device events in time order, leading spins kept, trailing spins
    kept) of one profiled call of fn between ``spins`` spins a side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(spins):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        fn()
        torch.cuda.synchronize()
        pad()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    lead = next((i for i, e in enumerate(events) if _SPIN not in e.name),
                len(events))
    return events, lead, sum(_SPIN in e.name for e in events[lead:])


def kernel_rows(fn):
    """(kernel name, device ms, count) of one profiled call, device events
    only (kernels, copies, fills), largest first, summed from the trace's
    events (key_averages() dropped some on the H100: 717 of a DeepSeek-V3
    batch-8 step's 737). The call runs between PROFILE_PAD spin kernels
    on each side, which are left out; while the trace kept no leading
    spin, and so may have lost the call's first events, it is profiled
    again (up to PROFILE_TRIES calls) with PROFILE_PAD_GROWTH times the
    spins."""
    spins = PROFILE_PAD
    for _ in range(PROFILE_TRIES):
        events, lead, trail = _profile(fn, spins)
        if lead:
            break
        log(f"profile: the trace lost all {spins} leading spin kernels "
            f"(kept {trail} of the trailing ones); again with "
            f"{spins * PROFILE_PAD_GROWTH}")
        spins *= PROFILE_PAD_GROWTH
    else:
        raise AssertionError(f"profile: {PROFILE_TRIES} traces each lost "
                             "all their leading spin kernels")
    agg: dict = {}
    for e in events:
        if _SPIN not in e.name:
            ms, n = agg.get(e.name, (0.0, 0))
            agg[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = [(k, ms, n) for k, (ms, n) in agg.items()]
    return sorted(rows, key=lambda r: -r[1])


def summarize_steps(steps: dict) -> dict:
    """{name: (wall ms, launches, kernel rows)} -> the profile record."""
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
            off_route=off_route(rows),
        )
        log(f"profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"in {kernels} kernels (port kernels {ours:.3f} ms), "
            f"launches {json.dumps(launches)}")
        for k, ms, n in rows[:12]:
            log(f"  {ms:9.3f} ms  x{n:<5d} {k[:90]}")
        if out[name]["off_route"]:
            raise AssertionError(
                f"profile {name}: calls left on first versions: "
                f"{out[name]['off_route']}")
    return out


def event_ms(fn, n: int = 8) -> float:
    """Mean device time of a call of fn between CUDA events over n calls
    (the card's clock: busy plus the gaps between kernels)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# profiled calls of each side at most before hold_replay_kernels decides
REPLAY_PROFILE_TRIES = 3
# kernels a replay may add to its body's own: before a replay PyTorch
# refills the seed and offset of each generator the graph holds (the
# default one and the owner's sampler), two fills each
REPLAY_PROLOGUE_MAX = 4


def _is_copy_event(name: str) -> bool:
    """A copy or fill of memory, not a kernel of the step: the trace names
    an eager step's "Memcpy DtoD (...)" / "Memset (...)", while a replay
    runs the copies its graph recorded as kernels named "memcpy32_post"
    (as the H100's trace names them)."""
    return name.lower().startswith(("memcpy", "memset"))


# the counts' key of every copy or fill event (_is_copy_event)
COPY_EVENTS = "<copy events>"


def _kernel_counts(rows) -> dict:
    out: dict = {}
    for k, _, n in rows:
        key = COPY_EVENTS if _is_copy_event(k) else k
        out[key] = out.get(key, 0) + n
    return out


def _port_counts(counts: dict) -> dict:
    """Counts by name -> the port kernels' counts by base name."""
    out: dict = {}
    for k, n in counts.items():
        base = port_kernel_base(k)
        if base:
            out[base] = out.get(base, 0) + n
    return out


# GraphStep -> its graph's port kernels (graph_port_kernels)
_GRAPH_NODES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def graph_port_kernels(step, what: str) -> dict:
    """The port kernels a captured GraphStep's graph launches, by base
    name: its kernel nodes, read from the graph's Graphviz dump
    (GraphStep.dump, the capture made under cuda_graph.DEBUG_GRAPHS; each
    node's block names its kernel once, mangled). One node a launch, so a
    replay launches these and nothing else of the port's, whatever its
    profiler trace names."""
    if step in _GRAPH_NODES:
        return _GRAPH_NODES[step]
    path = os.path.join(OUT_DIR, "graph_nodes.dot")
    step.dump(path)
    with open(path) as fh:
        text = fh.read()
    os.remove(path)
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', text)[1:]
    if not nodes:
        raise AssertionError(f"profile {what}: the graph's dump holds no "
                             f"node: {text[:300]!r}")
    out: dict = {}
    for node in nodes:
        base = port_kernel_base(node)
        if base:
            out[base] = out.get(base, 0) + 1
    _GRAPH_NODES[step] = out
    return out


def _repeated(counts: list):
    """Of one side's profiles (counts by name), the counts that repeat
    (the only profile's where there is one), else None."""
    if len(counts) == 1:
        return counts[0]
    return next((c for i, c in enumerate(counts) if c in counts[i + 1:]),
                None)


def replay_kernel_gaps(graphed: dict, eager: dict, nodes: dict,
                       copies: int) -> list:
    """What a replay lacks against the eager step: a port kernel whose
    graph nodes (``nodes``, by base name) are not as many as the eager
    step's profiled launches; any kernel the replay's trace (counts by
    name, every copy event under COPY_EVENTS) counts fewer times than the
    eager step's; more events added than its ``copies`` into the static
    buffers and REPLAY_PROLOGUE_MAX."""
    ports = _port_counts(eager)
    gaps = [f"{k}: {nodes.get(k, 0)} graph nodes against {ports.get(k, 0)}"
            for k in sorted(set(ports) | set(nodes))
            if nodes.get(k, 0) != ports.get(k, 0)]
    gaps += [f"{k[:70]}: {graphed.get(k, 0)} against {n}"
             for k, n in eager.items()
             if k != COPY_EVENTS and graphed.get(k, 0) < n]
    added = sum(graphed.values()) - sum(eager.values())
    if added > copies + REPLAY_PROLOGUE_MAX:
        gaps.append(f"{added} events added, at most {copies} copies + "
                    f"{REPLAY_PROLOGUE_MAX}")
    return gaps


def hold_replay_kernels(what: str, steps, graphed_fn, eager_fn, graphed_rows,
                        eager_rows, copies: int):
    """A replayed step held against the eager step, the independent
    evidence that a graph launches every kernel (the launch counts cannot
    show it: a replay re-adds what its capture counted): each port kernel
    as many times in the nodes of the captured graphs ``steps`` (the
    GraphSteps graphed_fn replays; graph_port_kernels) as in the eager
    step's trace, every kernel at least as many times in the
    replay's trace, at most ``copies`` + REPLAY_PROLOGUE_MAX events added
    (replay_kernel_gaps; copy and fill events counted together,
    _is_copy_event). The port kernels the replay's trace counts beyond
    the graph's nodes are recorded (``trace_port_surplus``). A trace can
    lose or gain events: while gaps remain, both sides are profiled again
    (up to REPLAY_PROFILE_TRIES calls each) and each side's counts that
    repeat are held. If a side's counts never repeat, the trace is
    recorded as unsteady and nothing is held; if both repeat and gaps
    remain, this raises. Returns the held profiles' rows and the
    record."""
    nodes: dict = {}
    for step in steps:
        for k, n in graph_port_kernels(step, what).items():
            nodes[k] = nodes.get(k, 0) + n
    tries = [[graphed_rows], [eager_rows]]
    while True:
        counts = [[_kernel_counts(rows) for rows in side] for side in tries]
        held = [_repeated(side) for side in counts]
        gaps = (replay_kernel_gaps(held[0], held[1], nodes, copies)
                if None not in held else None)
        if gaps == [] or len(tries[0]) == REPLAY_PROFILE_TRIES:
            break
        tries[0].append(kernel_rows(graphed_fn))
        tries[1].append(kernel_rows(eager_fn))
    totals = [[sum(r[2] for r in rows) for rows in side] for side in tries]
    rows_of = [side[c.index(h)] if h is not None else side[0]
               for side, c, h in zip(tries, counts, held)]
    traced = _port_counts(held[0] or counts[0][0])
    record = dict(held=gaps == [], profiled=totals[0],
                  eager_profiled=totals[1],
                  held_kernels=[sum(r[2] for r in rows) for rows in rows_of],
                  graph_port_kernels=sum(nodes.values()), copies=copies,
                  copy_events=[sum(r[2] for r in rows if _is_copy_event(r[0]))
                               for rows in rows_of],
                  trace_port_surplus={k: n - nodes.get(k, 0)
                                      for k, n in traced.items()
                                      if n > nodes.get(k, 0)})
    if held[0] is not None and held[1] is not None:
        record["added"] = sum(held[0].values()) - sum(held[1].values())
    if gaps == []:
        log(f"profile {what}: the replay holds against the eager step "
            f"({record['graph_port_kernels']} port kernel nodes; "
            f"{record['added']} events added, {copies} copies; profiled "
            f"{totals[0]} / {totals[1]}, held {record['held_kernels']}; "
            f"copy events {record['copy_events']}"
            + (f"; the trace names more port kernels than the graph "
               f"holds: {record['trace_port_surplus']}"
               if record["trace_port_surplus"] else "") + ")")
    elif gaps is None:
        record["unsteady"] = True
        log(f"profile {what}: a side's profiles never repeated (profiled "
            f"{totals[0]} / {totals[1]} kernels), nothing held")
    else:
        raise AssertionError(f"profile {what}: the replay does not hold "
                             f"against the eager step: {gaps[:8]} "
                             f"(profiled {totals[0]} / {totals[1]})")
    return rows_of[0], rows_of[1], record


def profile_steps(result: dict, gen, prefix: str = "") -> None:
    """Where the time of a 256-token prefill chunk (the second of a
    512-token prompt) and of a decode step over those 512 tokens goes,
    each step eager (prefill, decode_step) and replayed from the
    Generator's CUDA graphs (prefill_chunk_graphed, decode_step_graphed).
    Wall time: median of 3 unprofiled chunks (the eager ones each on a
    fresh cache; the replays over the step cache, its lengths set back to
    256 before each), mean of 8 unprofiled decode steps; event_ms: the mean
    between CUDA events over 8 more steps, 4 more chunks. Launches: per
    chunk and per step (a replay counts the captured step's). Device time
    by kernel: torch.profiler over one more chunk and one more step
    (kernel events only, so PyTorch ops are not counted twice), each
    replay's kernels held against the eager step's (hold_replay_kernels).
    Runs after the serve counts were read, so it adds nothing to them."""
    from ktransformers_tpu_torch.engine.cuda_graph import WARMUP
    from ktransformers_tpu_torch.engine.generate import GenerateConfig
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    prompt = torch.as_tensor(np.random.default_rng(200).integers(
        0, gen.spec.vocab_size, (1, 512)), device=gen.device)
    first, second = prompt[:, :256], prompt[:, 256:]
    spec = gen.spec
    linear = sum(spec.layer_kind(li) == "linear"
                 for li in range(spec.num_layers))

    def primed(chunks: int):
        cache = gen.new_cache()
        last = None
        for c in (first, second)[:chunks]:
            last, cache = gen.prefill(cache, c)
        return cache, last.argmax(-1)

    steps = {}
    # prefill chunk, eager: each call on the cache of the first chunk
    # (prefill rebinds the cache's lengths, so setting them back launches
    # nothing)
    cache, _ = primed(1)
    start = cache.lengths

    def chunk():
        cache.lengths = start
        gen.prefill(cache, second)

    walls = []
    for _ in range(3):
        reset_launches()
        walls.append(wall_ms(chunk))
    chunk_launches = dict(LAUNCHES)
    chunk_rows = kernel_rows(chunk)
    # the same chunk replayed from the Generator's prefill step over the
    # step cache (gen.prime: the prompt in two chunks, capturing the
    # step where the warm-up has not), its lengths set back in place
    pstep = gen.prefill_graph(256)
    for _ in range(2):
        if not pstep.graphed:
            gen.prime(prompt, GenerateConfig())
    if not pstep.graphed:
        raise AssertionError(f"profile {prefix}: the prefill step was not "
                             "captured")
    st = gen.decode_state()
    st.chunk(256).copy_(second)

    def chunk_graphed():
        st.cache.lengths.fill_(256)
        pstep()

    gwalls = []
    for _ in range(3):
        reset_launches()
        gwalls.append(wall_ms(chunk_graphed))
    pgraph_launches = dict(LAUNCHES)
    if pgraph_launches != chunk_launches:
        raise AssertionError(f"profile {prefix}: a prefill replay counts "
                             f"{pgraph_launches}, an eager chunk "
                             f"{chunk_launches}")
    # the replay's extra kernels: the lengths' fill, the body's copies of
    # the logits and lengths and each GatedDeltaNet layer's conv tail and
    # state (generate._commit)
    pgraph_rows, chunk_rows, pheld = hold_replay_kernels(
        prefix + "prefill_chunk_graphed", [pstep], chunk_graphed, chunk,
        kernel_rows(chunk_graphed), chunk_rows, 3 + 2 * linear)
    steps[prefix + "prefill_chunk"] = (statistics.median(walls),
                                       chunk_launches, chunk_rows)
    steps[prefix + "prefill_chunk_graphed"] = (statistics.median(gwalls),
                                               pgraph_launches, pgraph_rows)
    # decode step
    cache, tok = primed(2)
    state = {"tok": tok}

    def step():
        state["tok"], _ = gen.decode_step(state["tok"], cache)

    reset_launches()
    step()
    step_launches = dict(LAUNCHES)
    wall = wall_ms(lambda: [step() for _ in range(8)]) / 8
    eager_wall, eager_rows = wall, kernel_rows(step)
    # the same step replayed from the Generator's graph, over the same 512
    # tokens (gen.prime: the prompt in two chunks into the step cache)
    graph = gen.prime(prompt, GenerateConfig())
    while graph.calls <= WARMUP:
        graph()
    if not graph.graphed:
        raise AssertionError(f"profile {prefix}: the decode step was not "
                             "captured")
    reset_launches()
    graph()
    graph_launches = dict(LAUNCHES)
    wall = wall_ms(lambda: [graph() for _ in range(8)]) / 8
    if graph_launches != step_launches:
        raise AssertionError(f"profile {prefix}: a replay counts "
                             f"{graph_launches}, an eager step "
                             f"{step_launches}")
    # the body's copies: the next tokens, the lengths and each
    # GatedDeltaNet layer's conv tail and state (generate._commit)
    graph_rows, eager_rows, held = hold_replay_kernels(
        prefix + "decode_step_graphed", [graph], graph, step,
        kernel_rows(graph), eager_rows, 2 + 2 * linear)
    steps[prefix + "decode_step"] = (eager_wall, step_launches, eager_rows)
    steps[prefix + "decode_step_graphed"] = (wall, graph_launches,
                                             graph_rows)

    prof = result.setdefault("profile", {})
    prof.update(summarize_steps(steps))
    prof[prefix + "decode_step_graphed"]["replay_kernels"] = held
    prof[prefix + "prefill_chunk_graphed"]["replay_kernels"] = pheld
    for name, fn, n in (("decode_step", step, 8),
                        ("decode_step_graphed", graph, 8),
                        ("prefill_chunk", chunk, 4),
                        ("prefill_chunk_graphed", chunk_graphed, 4)):
        prof[prefix + name]["event_ms"] = event_ms(fn, n)
    pools = gen._graphs.pool_bytes()
    prof[prefix + "prefill_chunk_graphed"]["graph_pool_bytes"] = pools
    log(f"profile {prefix}: the Generator's captured steps reserve "
        f"{json.dumps(pools)} bytes of graph pools")


# activation preps of a DeepSeek-V2-Lite W4A8 step of the served batch of
# 8: its 57 dense projections (qkv_a and o_proj of 27 layers, lm_head, the
# layer-0 MLP's two) at 8 rows lie past w4a8_mma_kernel's fold crossover
# (w4a8_matmul.MMA_FOLD_MAX_ROWS); its 26 shared-expert FFN calls fold
# (w4a8_ffn.FFN_MMA_FOLD_MAX_ROWS) and so do its 48 routed rows (the GEMV)
DEEPSEEK_B8_PREPS = 57


def hold_prep(result: dict, prefix: str = "", b8: int = 0) -> None:
    """The activation preps of the W4A8 decode steps: none in a single-user
    decode step (every W4A8 call of one row or of the routed rows
    quantizes x inside its GEMV), ``b8`` in a served batch-8 step."""
    for name, want in (("decode_step", 0), ("serve_decode_step_b8", b8)):
        got = result["profile"][prefix + name]["launches"].get("w4a8_prep",
                                                               0)
        if got != want:
            raise AssertionError(f"profile {prefix}{name}: {got} w4a8_prep "
                                 f"launches, want {want}")


def profile_engine_steps(result: dict, gen, prefix: str = "") -> None:
    """The ServeEngine's steps. First three single requests of 512 tokens
    and one new token (no decode batch: a 512-token prefill step each,
    captured at the third, whose token is held to the eager step's). Then
    a decode step at a batch of 8 (512-token prompts, pipelined: mean wall
    of 8 steps, one more profiled), replayed from its graph and eager
    (serve_decode_step_b8_eager), and a fused mixed step (the fixed 8
    decode rows, 7 of them live, plus the second 256-token chunk of a new
    600-token prompt, whose host position is set back to 256 before each
    step, so every step runs the same chunk: one step for the wall time and
    the launches, the next one profiled), replayed from the (256, 1) key's
    graph and eager (serve_mixed_step_b8_s256_eager). A hybrid model's
    engine runs that step's decode and chunk as two passes, its decode
    step and its 256-token prefill step (serve_split_step_b8_s256). Each
    replay's kernels are held against the eager step's; the graph pools'
    bytes are recorded."""
    from ktransformers_tpu_torch.engine.cuda_graph import WARMUP
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

    vocab = gen.spec.vocab_size
    eng = ServeEngine(gen.params, gen.spec, SchedulerConfig(), num_pages=512,
                      enable_prefix_cache=False, device="cuda")

    def eager(fn):
        def run():
            eng.graph_steps = False
            try:
                return fn()
            finally:
                eng.graph_steps = True
        return run

    single = np.random.default_rng(399).integers(0, vocab, 512).tolist()
    for _ in range(WARMUP + 1):
        got = eng.generate_sync(single, max_new_tokens=1)
    if not eng._prefill_graph(512)[0].graphed:
        raise AssertionError(f"profile {prefix}: the engine's 512-token "
                             "prefill step was not captured")
    want = eager(lambda: eng.generate_sync(single, max_new_tokens=1))()
    if got != want:
        raise AssertionError(f"profile {prefix}: the replayed prefill step "
                             f"gives {got}, the eager one {want}")
    qs = [eng.submit(np.random.default_rng(400 + i).integers(
        0, vocab, 512).tolist(), max_new_tokens=400) for i in range(8)]
    while any(q.state != "decode" for q in qs):
        eng.step()
    for _ in range(4):
        eng.step()
    steps = {}
    reset_launches()
    eng.step()
    step_launches = dict(LAUNCHES)
    wall = wall_ms(lambda: [eng.step() for _ in range(8)]) / 8
    graph_rows = kernel_rows(eng.step)
    if not eng._graphs.captured():
        raise AssertionError("profile: the engine's decode step was not "
                             "captured")
    eager_step = eager(eng.step)
    # the same steps eager
    reset_launches()
    eager_step()
    eager_launches = dict(LAUNCHES)
    eager_wall = wall_ms(lambda: [eager_step() for _ in range(8)]) / 8
    if eager_launches != step_launches:
        raise AssertionError(f"profile {prefix}: a replayed engine step "
                             f"counts {step_launches}, an eager one "
                             f"{eager_launches}")
    # one body both ways: a replay adds no copy
    graph_rows, eager_rows, held = hold_replay_kernels(
        prefix + "serve_decode_step_b8", [eng._decode_graph(False)], eng.step,
        eager_step, graph_rows, kernel_rows(eager_step), 0)
    steps[prefix + "serve_decode_step_b8"] = (wall, step_launches,
                                              graph_rows)
    steps[prefix + "serve_decode_step_b8_eager"] = (eager_wall,
                                                    eager_launches,
                                                    eager_rows)
    # the mixed (or split) step: the late prompt's first chunk, then its
    # second again and again
    eng.cancel(qs[7])
    late = eng.submit(np.random.default_rng(500).integers(
        0, vocab, 600).tolist(), max_new_tokens=4)
    eng.step()
    hybrid = gen.spec.hybrid
    chunk_step = (eng._prefill_graph(256) if hybrid
                  else eng._mixed_graph(1, 256))[0]

    def late_step():
        late.prefill_pos = 256
        eng.step()

    eager_late = eager(late_step)
    fused0 = eng.mixed_steps_fused
    while not chunk_step.graphed and chunk_step.calls <= WARMUP:
        late_step()
    if not chunk_step.graphed:
        raise AssertionError(f"profile {prefix}: the 256-token "
                             f"{'prefill' if hybrid else 'mixed'} step was "
                             "not captured")
    reset_launches()
    wall = wall_ms(late_step)
    step_launches = dict(LAUNCHES)
    rows = kernel_rows(late_step)
    reset_launches()
    eager_wall = wall_ms(eager_late)
    eager_launches = dict(LAUNCHES)
    if eager_launches != step_launches:
        raise AssertionError(f"profile {prefix}: a replayed chunk step "
                             f"counts {step_launches}, an eager one "
                             f"{eager_launches}")
    name = "serve_split_step_b8_s256" if hybrid else \
        "serve_mixed_step_b8_s256"
    # a hybrid's split step replays the decode graph and the chunk's
    rows, eager_rows, chunk_held = hold_replay_kernels(
        prefix + name, [eng._decode_graph(False), chunk_step] if hybrid
        else [chunk_step], late_step, eager_late, rows,
        kernel_rows(eager_late), 0)
    ran = eng.mixed_steps_fused - fused0
    if (ran > 0) == hybrid or late.prefill_pos != 512:
        raise AssertionError(f"profile {prefix}: {ran} chunk steps ran "
                             f"fused, the late prompt at {late.prefill_pos}")
    steps[prefix + name] = (wall, step_launches, rows)
    steps[prefix + name + "_eager"] = (eager_wall, eager_launches, eager_rows)
    kinds = ("prefill",) if hybrid else ("prefill", "mixed")
    captured = {k: eng._graphs.captured(k) for k in kinds}
    if not all(captured.values()):
        raise AssertionError(f"profile {prefix}: captured {captured}")
    prof = result.setdefault("profile", {})
    prof.update(summarize_steps(steps))
    prof[prefix + "serve_decode_step_b8"]["replay_kernels"] = held
    prof[prefix + name]["replay_kernels"] = chunk_held
    prof[prefix + name]["graph_pool_bytes"] = eng._graphs.pool_bytes()
    log(f"profile {prefix}: the engine's captured steps {json.dumps(captured)}"
        f" reserve {json.dumps(eng._graphs.pool_bytes())} bytes of graph "
        "pools")
    eng.cancel(late)


# -------------------------------------------------------------------- sft

SFT_SEQ = 512
SFT_STEPS = 4
# dx float32 on both sides from the same bf16 operands; the kernel's tensor
# cores add each k16 step's products with truncated alignment (not IEEE
# round-to-nearest), an error growing with the contraction: 3.8e-6 at
# N = 3648, 1.2e-4 at N = 102,400 (lm_head) of the largest |dx|
SFT_KERNEL_TOL = 1e-3


def sft_kernel_checks(rows: list, entries: dict) -> None:
    """Rows 16 and 17 (csrc/quant_matmul_t.cu) at the shapes of a 512-token
    step of DeepSeek-V2-Lite against their plain versions on the card.
    dy is bf16 (the step's compute dtype), dx float32. Tolerance
    SFT_KERNEL_TOL of the largest |dx|: both sides round dy (times the
    scale for int8 / fp8) and the decoded weight to bf16 and sum in float32
    (the kernel on tensor cores, the plain version in cuBLAS's f32 FMA).
    Bound: dy, the weight bytes of the experts the rows use and dx over the
    memory rate, against 2 M N K over the bf16 peak. Library yardsticks
    (never on the path): row 16 torch.matmul(dy, W_bf16.T) on the
    dequantized weight; row 17's grouped rows torch._grouped_mm over the
    bf16-dequantized, transposed experts, as rows 8 and 11 time it; its
    gathered entry none (no one PyTorch call takes per-row experts). Also
    row 8's forward over the step's 3,072 sorted rows
    (w4a8_mma_kernel beside the first version; yardstick grouped_mm); the
    step's dense row-1 shapes are in kernel_checks."""
    from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as QT
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.formats import dequantize

    dev = torch.device("cuda")
    bf = torch.bfloat16
    check = make_check(rows, entries)
    rd, rn, w = draw(4321)
    m = SFT_SEQ

    def wbytes(wt, experts=None):
        per = [t for t in (wt.data, wt.scales, wt.zeros) if t is not None]
        if experts is None:
            return nbytes(*per)
        return experts * nbytes(*(t[0] for t in per))

    def dense(label, wt, main=False, iters=20):
        k, n = wt.in_features, wt.out_features
        dy = rn(m, n)
        wdq = dequantize(wt, bf)
        check("quant_matmul_t", label, SFT_KERNEL_TOL,
              lambda: QT.quant_matmul_t(dy, wt),
              lambda: QT.quant_matmul_t_ref(dy, wt),
              lambda: QT.dense_t_launcher(dy, wt),
              nbytes(dy) + wbytes(wt) + m * k * 4, 2 * m * n * k,
              BF16_FLOPS_PER_S, library=lambda: torch.matmul(dy, wdq.T),
              main=main, kernel_main=main, iters=iters,
              **routed(QT_ROUTES, QT._route(wt),
                       lambda: QT.dense_t_launcher(dy, wt, "rows")))

    # row 16 on the W4A8 weights of the step (offset-lo int4_g): every
    # projection whose input needs a gradient, dy [512, N] -> dx [512, K]
    for k, n, gs, label, main in (
        (2048, 3648, 128, "qkv_a 3648->2048", True),
        (2048, 2048, 128, "o_proj 2048->2048", False),
        (2048, 102400, 128, "lm_head 102400->2048", False),
        (2048, 5632, 128, "shared gate_up 5632->2048", False),
        (1408 * 2, 2048, 128, "shared down 2048->2816", False),
        (2048, 21888, 128, "layer-0 gate_up 21888->2048", False),
        (10944, 2048, 96, "layer-0 down 2048->10944 (gs 96)", False),
        (2048, 1824, 128, "N=1824", False),
    ):
        dense(f"int4_g offset-lo M={m} {label}", w((k, n), gs), main)
    for kind in QUANT_KINDS:
        dense(f"{kind} M={m} qkv_a 3648->2048", rd.q((2048, 3648), kind, 128),
              iters=10)

    # row 17: the routed experts' gate_up / down transposes over the 3072
    # sorted rows of 512 tokens x top-6, and the gathered entry at 6 rows
    e, d, f = 64, 2048, 1408
    g_cpu = torch.Generator().manual_seed(5)
    topk = torch.stack([torch.randperm(e, generator=g_cpu)[:6]
                        for _ in range(m)]).to(dev)
    sizes = torch.bincount(topk.reshape(-1), minlength=e).to(torch.int32)
    used = int((sizes > 0).sum())
    ids6 = topk[0].to(torch.int32)
    for k, n, what in ((d, 2 * f, "gate_up"), (f, d, "down")):
        wt = w((e, k, n))
        dy = rn(m * 6, n)
        wdqt = dequantize(wt, bf).transpose(1, 2).contiguous()
        check("grouped_quant_matmul_t",
              f"int4_g offset-lo {m * 6} sorted rows {what}^T "
              f"[64, {k}, {n}]", SFT_KERNEL_TOL,
              lambda: QT.grouped_quant_matmul_t(dy, wt, sizes),
              lambda: QT.grouped_quant_matmul_t_ref(dy, wt, sizes),
              lambda: QT.grouped_t_launcher(dy, wt, sizes),
              nbytes(dy) + wbytes(wt, used) + m * 6 * k * 4,
              2 * m * 6 * n * k, BF16_FLOPS_PER_S,
              library=grouped_mm(dy, wdqt, sizes),
              main=(what == "gate_up"), iters=10,
              **routed(QT_ROUTES, QT._route(wt),
                       lambda: QT.grouped_t_launcher(dy, wt, sizes, "rows")))
        del wdqt
        dy6 = rn(6, n)
        check("grouped_quant_matmul_t",
              f"gathered entry 6 rows {what}^T [64, {k}, {n}]",
              SFT_KERNEL_TOL,
              lambda: QT.gathered_quant_matmul_t(dy6, wt, ids6),
              lambda: QT.gathered_quant_matmul_t_ref(dy6, wt, ids6),
              lambda: QT.gathered_t_launcher(dy6, wt, ids6),
              nbytes(dy6) + wbytes(wt, 6) + 6 * k * 4, 2 * 6 * n * k,
              BF16_FLOPS_PER_S, **routed(QT_ROUTES, QT._route(wt),
                       lambda: QT.gathered_t_launcher(dy6, wt, ids6,
                                                      "rows")))
        # row 8 forward on the same experts and rows (the step's routed
        # experts: adapters keep them off the fused FFN), bf16 x
        x = rn(m * 6, k)
        wdq = dequantize(wt, bf)
        check("grouped_w4a8_matmul",
              f"sft {m * 6} sorted rows {what} [64, {k}, {n}]", 1e-2,
              lambda: MM.grouped_w4a8_matmul(x, wt, sizes),
              lambda: MM.grouped_w4a8_matmul_ref(x, wt, sizes),
              lambda: MM.grouped_launcher(x, wt, sizes),
              nbytes(x) + wbytes(wt, used) + m * 6 * n * 2,
              2 * m * 6 * n * k, INT8_OPS_PER_S,
              library=grouped_mm(x, wdq, sizes), iters=10,
              fold=fold_pair(
                  lambda f: MM.grouped_launcher(x, wt, sizes, None, f),
                  lambda: MM.prep_activations(x, k, wt.group_size),
                  MM.folds(MM.route(m * 6, "grouped", wt.group_size, n),
                           m * 6, k, wt.group_size),
                  MM.mma_fold_fits(m * 6, k, wt.group_size, MM.MMA_STAGES,
                                   64)),
              **routed(W4A8_ROUTES,
                       MM.route(m * 6, "grouped", wt.group_size, n),
                       lambda: MM.grouped_launcher(x, wt, sizes, "rows")))
        del wt, wdq


# the SFT parity model's tolerances (int8 weights, float32 compute): the
# loss as a share of itself, each LoRA gradient's error as a share of its
# norm. The int8 weights have no activation requant, so the two devices
# differ by the order of float32 sums, which the transposed kernels' bf16
# rounding of dy can turn into one bf16 step (2^-8) of an element of dy:
# at most 2^-8 of a gradient's norm
SFT_LOSS_TOL = 1e-4
SFT_GRAD_TOL = 2.0 ** -8
# a ZeRO-1 step's change of a LoRA leaf against one device's, as a share of
# its norm (hold_zero1_step). Adam's early steps move each element by about
# the learning rate times the sign of its gradient, so an element whose
# gradient is below the float32 sums' spread can move the other way: the
# card read 5.9e-2 (step 0) and 1.2e-2 (step 1), and 1.39 with the dp
# halves swapped
ZERO1_STEP_TOL = 1e-1


def sft_parity(result: dict) -> None:
    """DeepSeek-V2-Lite at full width cut to 2 layers (one dense, one MoE
    layer) with rank-8 adapters: one Trainer step on 64 seeded tokens,
    float32 compute, on the CPU (plain versions) and on the card (kernels,
    rows 16 and 17 in the backward). int8 weights: the loss within
    SFT_LOSS_TOL, every LoRA gradient within SFT_GRAD_TOL of its norm, and
    every updated leaf equal to the CPU's (to 1e-3 of the learning rate)
    wherever the CPU's gradient is larger than 4 SFT_GRAD_TOL of its leaf's
    largest, so that its sign is settled (Adam's first step moves each
    element by about the learning rate times the sign of its gradient).
    W4A8 weights (int8 activation codes that float32 sums in another order
    can flip): recorded, and held finite."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.sft import (
        LoRAConfig,
        TrainConfig,
        Trainer,
        init_lora,
    )
    from ktransformers_tpu_torch.sft.lora import lora_leaves
    from ktransformers_tpu_torch.utils.device_prep import params_to

    t0 = time.perf_counter()
    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    toks = np.random.default_rng(6).integers(0, spec.vocab_size, (1, 64))
    lr = TrainConfig().learning_rate
    out = {}
    for kind, tol in (("int8", SFT_GRAD_TOL), ("int4_g", None)):
        params = card_drawn(spec, seed=7, quant=kind)
        params = init_lora(params, spec, LoRAConfig(rank=8), seed=0)
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = Trainer(params_to(params, dev), spec,
                         TrainConfig(seq_len=64), device=dev)
            loss, grads = tr.loss_and_grads(toks, toks)
            with torch.no_grad():
                tr._update(grads)
            runs[dev] = (loss, [g.float().cpu() for g in grads],
                         [(n, t.detach().float().cpu())
                          for n, t in lora_leaves(tr.lora)])
            del tr
        (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs["cuda"]
        before = {n: t.float() for n, t in lora_leaves(params)}
        loss_err = abs(lg - lc) / abs(lc)
        grad_errs, leaf_errs, unsettled = {}, {}, 0
        for (name, a_cpu), a_gpu, g_cpu, g_gpu in zip(pc, [t for _, t in pg],
                                                      gc, gg):
            grad_errs[name] = float((g_gpu - g_cpu).norm()
                                    / g_cpu.norm().clamp_min(1e-30))
            # (the a factors' gradients are exactly zero at the first step:
            # their b factors start at zero)
            settled = g_cpu.abs() > 4 * SFT_GRAD_TOL * g_cpu.abs().max()
            if settled.any():
                unsettled += int((~settled).sum())
            step_diff = ((a_gpu - before[name]) - (a_cpu - before[name])).abs()
            leaf_errs[name] = float(step_diff[settled].max()) / lr \
                if settled.any() else 0.0
        finite = all(bool(torch.isfinite(g).all()) for g in gg) \
            and np.isfinite(lg)
        worst_g = max(grad_errs.values())
        worst_p = max(leaf_errs.values())
        out[kind] = dict(loss_cpu=lc, loss_card=lg, loss_rel_err=loss_err,
                         grad_rel_err=grad_errs, leaf_err_over_lr=leaf_errs,
                         unsettled_elements=unsettled,
                         tol=None if tol is None else dict(
                             loss=SFT_LOSS_TOL, grad=SFT_GRAD_TOL,
                             leaf_over_lr=1e-3))
        log(f"sft parity {kind} (card vs CPU): loss {lg:.6f} vs {lc:.6f} "
            f"(rel {loss_err:.2e}), worst LoRA gradient rel {worst_g:.2e}, "
            f"worst settled leaf step {worst_p:.2e} of the learning rate, "
            f"{unsettled} elements with unsettled sign "
            f"(held: {tol is not None})")
        if not finite:
            raise AssertionError(f"sft parity {kind}: non-finite loss or "
                                 "gradients on the card")
        if tol is not None and (loss_err > SFT_LOSS_TOL or worst_g > tol
                                or worst_p > 1e-3):
            raise AssertionError(f"sft parity {kind} failed: {out[kind]}")
        del params
    out["seconds"] = time.perf_counter() - t0
    result["sft_parity"] = out


def sft_step_launches(spec, params, rows: int) -> dict:
    """Launches of one Trainer step of ``rows`` tokens with rank-8 adapters
    on o_proj and the routed experts (the default targets after the fused
    qkv_a), per-layer remat, on the W4A8 parameters ``params``, derived
    from the model:
    - forward, each layer run twice (the pass and its rematerialization),
      lm_head once: dense_w4a8_matmul on qkv_a and o_proj of every layer;
      a GLU MLP (a dense layer's, or a MoE layer's shared experts, which
      carry no adapter) takes the fused dense FFN where the JAX package
      fuses it (w4a8_ffn.dense_mlp_fused), else two dense_w4a8_matmul;
      the two grouped expert matmuls of every MoE layer (adapters keep
      them off the fused FFN). The rematerialization stops once the last
      tensor the backward needs is rebuilt (torch.utils.checkpoint's
      early stop), so an unfused MLP's down projection, which ends its
      layer and saves nothing for the backward, runs once;
    - backward: each fused FFN's rule recomputes its gate_up product
      (dense_w4a8_matmul); dx (quant_matmul_t) of qkv_a and o_proj in
      every layer but the first (its input, the embedding, and so its
      attention need no gradient), of gate_up and down of every GLU MLP,
      and of lm_head; dx of the two expert matmuls of every MoE layer
      (grouped_quant_matmul_t);
    - one activation prep per W4A8 matmul or FFN call whose kernel does not
      quantize x itself (w4a8_matmul.folds, w4a8_ffn.ffn_folds: a step of
      512 tokens lies past the tensor-core kernels' crossovers)."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
        dense_mlp_fused,
        ffn_folds,
    )

    act = spec.activation
    mlps = [lp["moe"]["shared"] if "moe" in lp else lp["mlp"]
            for lp in params["layers"]]
    fused = sum(dense_mlp_fused(m["gate_up"], m["down"], act.kind,
                                act.swiglu_limit, rows) for m in mlps)
    n_layers = len(mlps)
    moe = sum("moe" in lp for lp in params["layers"])
    fwd_dense = 2 * n_layers + 2 * (n_layers - fused)
    dense = 2 * fwd_dense - (n_layers - fused) + 1 + fused
    ffn = 2 * fused
    grouped = 2 * 2 * moe
    k = spec.hidden_size
    prep = (dense * (not MM.folds("mma", rows, k, 128))
            + ffn * (not ffn_folds("mma", rows, k, 128))
            + grouped * (not MM.folds("mma", spec.moe.top_k * rows, k, 128)))
    return {
        "dense_w4a8_matmul": dense,
        "dense_w4a8_ffn": ffn,
        "grouped_w4a8_matmul": grouped,
        "w4a8_prep": prep,
        "quant_matmul_t": 2 * (n_layers - 1) + 2 * n_layers + 1,
        "grouped_quant_matmul_t": 2 * moe,
    }


SFT_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "dense_w4a8_ffn",
               "grouped_w4a8_matmul", "quant_matmul_t",
               "grouped_quant_matmul_t")


def _is_transposed_kernel(name: str) -> bool:
    return "quant_rows_t_kernel" in name or "quant_wgmma_t_kernel" in name


def sft_run(result: dict) -> None:
    """The SFT path at full depth, as scripts/bench_sft.py sets it up:
    DeepSeek-V2-Lite (27 layers), int4_g weights prepared for W4A8, rank-8
    adapters (default targets), one sequence of 512 seeded tokens (labels
    = inputs), bf16 compute, per-layer remat, default TrainConfig."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.quant.formats import QTensor
    from ktransformers_tpu_torch.sft import (
        LoRAConfig,
        TrainConfig,
        Trainer,
        init_lora,
    )
    from ktransformers_tpu_torch.sft.lora import lora_leaves
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    spec = spec_from_hf_config(bench_model_cfg())
    t0 = time.perf_counter()
    params = prepare_params(init_params_synthetic(
        spec, quant="int4_g", moe_quant="int4_g", device="cuda"), spec)
    params = init_lora(params, spec, LoRAConfig(rank=8))
    trainer = Trainer(params, spec, TrainConfig(seq_len=SFT_SEQ, remat=True),
                      compute_dtype=torch.bfloat16, device="cuda")
    del params
    base = [t for t in _leaves(trainer.base)]
    base_copy = [t.cpu() for t in base]  # on the host: not in the peak
    pbytes = sum(t.numel() * t.element_size() for t in base)
    lbytes = sum(t.numel() * t.element_size() for t in trainer.leaves)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"sft: {len(trainer.leaves)} LoRA leaves ({lbytes / 1e6:.1f} MB) on "
        f"{pbytes / 1e9:.3f} GB of base parameters, ready in {init_s:.1f} s")
    ids = np.random.default_rng(0).integers(0, spec.vocab_size, (1, SFT_SEQ))
    want = sft_step_launches(spec, trainer.base, SFT_SEQ)

    def counts():
        torch.cuda.synchronize()
        return {k: v for k, v in LAUNCHES.items() if v}

    def routed_counts():
        return {k: v for k, v in ROUTED_LAUNCHES.items() if v}

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss_first = trainer.train_step(ids, ids)
    first_s = time.perf_counter() - t0
    first = counts()
    b_moved = all(bool(t.abs().max() > 0) for n, t in
                  lora_leaves(trainer.lora) if n.endswith("b"))
    reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.train_step(ids, ids) for _ in range(SFT_STEPS)]
    step_s = (time.perf_counter() - t0) / SFT_STEPS
    timed = counts()
    timed_routed = routed_counts()
    peak = torch.cuda.max_memory_allocated()
    frozen = all(torch.equal(a.cpu(), b) for a, b in zip(base, base_copy))
    del base_copy

    # one profiled step: device time by kernel (after the counts were read)
    rows = kernel_rows(lambda: trainer.train_step(ids, ids))
    busy = sum(r[1] for r in rows)
    t_ms = {name: sum(r[1] for r in rows if pick(r[0]))
            for name, pick in (
                ("quant_matmul_t + grouped_quant_matmul_t",
                 _is_transposed_kernel),
                ("port kernels", _is_port_kernel))}
    out = dict(
        seq=SFT_SEQ, batch=1, rank=8, remat=True, compute_dtype="bfloat16",
        init_s=init_s, first_step_s=first_s, step_s=step_s,
        tok_s=SFT_SEQ / step_s, loss_first=loss_first, loss_last=losses[-1],
        losses=losses, max_memory_allocated=peak, params_bytes=pbytes,
        lora_bytes=lbytes, lora_b_moved=b_moved, base_unchanged=frozen,
        launches_first_step=first, launches=timed, launches_per_step=want,
        routed_launches=timed_routed,
        profile=dict(device_busy_ms=busy, wall_ms=step_s * 1e3,
                     idle_share=1.0 - busy / (step_s * 1e3),
                     kernel_ms=t_ms,
                     transposed_share=t_ms[
                         "quant_matmul_t + grouped_quant_matmul_t"] / busy
                     if busy else None,
                     device_kernels=sum(r[2] for r in rows),
                     top=[dict(name=k[:90], ms=ms, count=n)
                          for k, ms, n in rows[:15]]),
    )
    result["sft"] = out
    log(f"sft: first step {first_s:.3f} s, then {step_s:.3f} s a step "
        f"({SFT_SEQ / step_s:.1f} tok/s) over {SFT_STEPS} steps; loss "
        f"{loss_first:.4f} -> {losses[-1]:.4f}; max_memory_allocated "
        f"{peak / 1e9:.3f} GB; every LoRA b moved: {b_moved}; base "
        f"bit-unchanged: {frozen}")
    log(f"sft launches per step {json.dumps(first)} (want {json.dumps(want)}"
        f"), over {SFT_STEPS} steps on the redesigned kernels "
        f"{json.dumps(timed_routed)}")
    log(f"profile sft_step: wall {step_s * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms in {out['profile']['device_kernels']} kernels, rows "
        f"16 + 17 {t_ms['quant_matmul_t + grouped_quant_matmul_t']:.1f} ms")
    for k, ms, n in rows[:15]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    out["profile"]["off_route"] = off_route(rows)
    if out["profile"]["off_route"]:
        raise AssertionError("sft step: calls left on first versions: "
                             f"{out['profile']['off_route']}")
    if not (np.isfinite(loss_first) and all(np.isfinite(losses))):
        raise AssertionError(f"sft: non-finite loss {loss_first} {losses}")
    if not b_moved or not frozen:
        raise AssertionError("sft: adapters did not move or the base changed")
    if first != want or timed != {k: SFT_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"sft launches {first} / {timed}, want {want} "
                             "per step")
    missing = [k for k in SFT_KERNELS if timed.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the sft run: {missing}")
    del trainer


# ----------------------------------------------------------- DeepSeek-V3


def v3_cfg(layers: int = 6, first_dense: int = 3) -> dict:
    """DeepSeek-V3 at its published widths (models/spec.DEEPSEEK_V3, the
    deepseek-ai/DeepSeek-V3 config.json) with the depth cut: the served
    model keeps 6 of its 61 layers, 3 dense as published and 3 MoE; the
    parity model 2, one of each."""
    from ktransformers_tpu_torch.models.spec import DEEPSEEK_V3

    return dict(DEEPSEEK_V3, num_hidden_layers=layers,
                first_k_dense_replace=first_dense)


def dequant_experts(wt, step: int = 16) -> torch.Tensor:
    """bf16 [E, K, N] of an expert stack, ``step`` experts at a time (the
    float32 intermediate of one dequantize of all 256 of V3's would not
    fit)."""
    import dataclasses

    from ktransformers_tpu_torch.quant.formats import dequantize

    e = wt.data.shape[0]
    out = torch.empty(e, wt.in_features, wt.out_features,
                      dtype=torch.bfloat16, device=wt.data.device)
    for lo in range(0, e, step):
        part = dataclasses.replace(
            wt, data=wt.data[lo : lo + step],
            scales=wt.scales[lo : lo + step],
            zeros=None if wt.zeros is None else wt.zeros[lo : lo + step])
        out[lo : lo + step] = dequantize(part, torch.bfloat16)
    return out


# the rows of V3's dense calls on its paths: a decode step, the engine's
# decode batch of 8, a prefill chunk, a mixed step of 8 + 256 rows
V3_ROWS = (1, 8, 256, 264)


def v3_kernel_checks(rows: list, entries: dict) -> None:
    """The kernels of the DeepSeek-V3 path at its widths (hidden 7168, 128
    MLA heads, 256 experts top-8, q_lora 1536) against their plain
    versions on the card (see make_check); rows of chip_smoke.json's
    kernel_rows, labelled "v3", none an entry of the kernels line:
    - row 1 at M = 1, 8, 256 and 264 (a decode step, the engine's batch
      of 8, a prefill chunk, the mixed step's 8 + 256 rows): qkv_a 7168 ->
      2112, q_b 1536 -> 24576, o_proj 16384 -> 7168, lm_head 7168 ->
      129280;
    - row 3: the shared expert (I = 2048) and the dense MLP (I = 18432) at
      the same M (both fused, as the JAX package's dense_ffn_plan
      decides; at M = 8 the tensor-core gate_up quantizes x itself, its A
      tile at K = 7168 beside its ring: 230,400 of 232,448 bytes);
    - rows 7 and 8: the routed experts, which the fused FFN refuses (one
      expert's gate_up and down blocks are 44 MB against the JAX package's
      15 MB budget, ffn_fits / grouped_ffn_fits): gathered at 8 and 64 rows
      (1 and 8 tokens x top-8), grouped at 4096 rows (512 tokens x 8) over
      256 experts, gate_up [256, 7168, 4096] and down [256, 2048, 7168];
    - row 5 at H = 128, 512 cached rows of 1024, V3's softmax scale;
    - rows 12 and 14 at H = 128 (paged_kernel_checks)."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.rope import (
        RopeConfig,
        precompute_rope_tables,
        rope_rotation_matrix,
    )

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    _, rn, w = draw(3003)
    sms = MM.sm_count(dev)
    d, e, f, top = 7168, 256, 2048, 8
    scale = spec_from_hf_config(v3_cfg()).attention.softmax_scale

    for k, n, what in ((d, 2112, "qkv_a"), (1536, 24576, "q_b"),
                       (16384, d, "o_proj"), (d, 129280, "lm_head")):
        wt = w((k, n))
        for m in V3_ROWS:
            dense_w4a8_check(check, rn(m, k), wt,
                             f"v3 {what} {k}->{n} M={m}", sms)
        del wt
        torch.cuda.empty_cache()

    for inter, what in ((f, "shared"), (18432, "dense MLP")):
        sgu, sdn = w((d, 2 * inter)), w((inter, d))
        for m in V3_ROWS:
            dense_ffn_check(check, rn(m, d), sgu, sdn,
                            f"v3 {what} I={inter} M={m}", sms)
        del sgu, sdn
        torch.cuda.empty_cache()

    g_cpu = torch.Generator().manual_seed(3)

    def routing(tokens):
        return torch.stack([torch.randperm(e, generator=g_cpu)[:top]
                            for _ in range(tokens)]).to(dev)

    for k, n, what in ((d, 2 * f, "gate_up"), (f, d, "down")):
        wt = w((e, k, n))
        for tokens in (1, 8):
            ids = routing(tokens).reshape(-1).to(torch.int32)
            gathered_mm_check(check, rn(ids.shape[0], k), wt, ids,
                              f"v3 {what} gathered {ids.shape[0]} rows "
                              f"({tokens} tok x 8) [256, {k}, {n}]")
        sizes = torch.bincount(routing(512).reshape(-1), minlength=e).to(
            torch.int32)
        x = rn(512 * top, k)
        wdq = dequant_experts(wt)
        grouped_mm_check(check, x, wt, sizes,
                         f"v3 {what} grouped 4096 rows (512 tok x 8), 256 "
                         f"experts [256, {k}, {n}]",
                         library=grouped_mm(x, wdq, sizes))
        del wt, wdq, x
        torch.cuda.empty_cache()

    # row 5 at 128 heads
    h, r, dr, smax, length = 128, 512, 64, 1024, 512
    cos, sin = precompute_rope_tables(RopeConfig(dim=dr, max_position=smax,
                                                 interleaved=True), dev)
    rot = rope_rotation_matrix(cos[length][None], sin[length][None], True)
    qn, qp, kv = rn(1, h, r), rn(1, h, dr), rn(1, 1, r + dr)
    gamma = torch.ones(r, device=dev)
    ckv, kpe = rn(1, smax, r), rn(1, smax, dr)
    ckv[:, length:] = float("nan")
    kpe[:, length:] = float("nan")
    lengths = torch.full((1,), length, dtype=torch.int32, device=dev)
    args = (qn, qp, kv, gamma, rot, ckv, kpe, lengths, scale, 1e-6)
    lib_c = torch.nan_to_num(ckv[:, : length + 1])
    lib_q = torch.cat([qn, qp], dim=-1)[:, :, None]
    lib_k = torch.cat([lib_c, torch.nan_to_num(kpe[:, : length + 1])],
                      dim=-1)[:, None].expand(-1, h, -1, -1)
    lib_v = lib_c[:, None].expand(-1, h, -1, -1)
    check("mla_decode_fused", f"v3 decode H=128 cached={length} S={smax}",
          1e-2, lambda: MD.mla_decode_fused(*args),
          lambda: MD.mla_decode_fused_ref(*args),
          lambda: MD.mla_launcher(*args),
          length * (r + dr) * 2 + nbytes(qn, qp, kv) + h * r * 2,
          2 * h * (length + 1) * (2 * r + dr), BF16_FLOPS_PER_S,
          library=lambda: tF.scaled_dot_product_attention(
              lib_q, lib_k, lib_v, scale=scale),
          **routed(MLA_DECODE_ROUTES, MD.route(torch.bfloat16),
                   lambda: MD.mla_launcher(*args, "fused")))
    del ckv, kpe, lib_c, lib_k, lib_v
    paged_kernel_checks(check, rn, dev, h=h, scale=scale, prefix="v3 ")


def v3_variant():
    """DeepSeek-V3 at full width cut to 2 layers (layer 0 dense, layer 1
    MoE; first_k_dense_replace 1) with int4_g weights repacked for W4A8:
    (name, spec, prepared CPU params, None), held by moe_parity. The
    weights are drawn and prepared on the card (fast) and copied to the
    host, so both devices run the same bits."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(v3_cfg(layers=2, first_dense=1))
    return "v3_w4a8", spec, card_drawn(spec), None


def routes_of(fn, module=None):
    """(fn(), picks): fn run with the expert set each MoE layer of
    ``module`` (models/model.py unless another, such as
    offload/host_engine.py) routes each token to recorded, one list of
    frozensets a call of its router, in call order."""
    if module is None:
        from ktransformers_tpu_torch.models import model as module

    picks, route = [], module.route

    def recording(*args, **kwargs):
        idx, weights = route(*args, **kwargs)
        picks.append([frozenset(r) for r in idx.tolist()])
        return idx, weights

    module.route = recording
    try:
        return fn(), picks
    finally:
        module.route = route


def moe_parity(what: str, spec, params, prompt: int) -> dict:
    """parity_rows of a W4A8 MoE model card vs CPU, held as ``w4a8`` is
    (hold_rows, tolerance None), with the expert set each MoE layer routes
    each token to recorded on both devices (routes_of). A row's logits see
    the routes of every MoE layer but the last for each token up to the
    row (through the attention after them) and the last MoE layer's route
    of the row's own token. A row further than NEAR_TIE from the CPU's
    must be one where such a route differs: a router's top-k is a discrete
    choice that an int8 activation code flipped by the rounding order can
    move; every other row stays inside the W4A8 spread. Returns hold_rows'
    record with ``rerouted`` per row."""
    card, card_picks = routes_of(
        lambda: parity_rows(params, spec, "cuda", prompt))
    cpu, cpu_picks = routes_of(
        lambda: parity_rows(params, spec, "cpu", prompt))
    return hold_routed(f"parity {what} (card vs CPU)", card, card_picks,
                       cpu, cpu_picks)


def hold_routed(what: str, card, card_picks, cpu, cpu_picks) -> dict:
    """moe_parity's rule for logits rows ``card`` against ``cpu`` (one row
    a forward, each forward's router calls in ``*_picks``): hold_rows with
    tolerance None, and a row past NEAR_TIE only where a route it sees
    differs."""
    held = hold_rows(card, cpu, what, None)
    steps = card.shape[0]
    layers = len(card_picks) // steps
    if (not layers or layers * steps != len(card_picks)
            or len(cpu_picks) != len(card_picks)):
        raise AssertionError(f"{what}: {len(card_picks)} / "
                             f"{len(cpu_picks)} router calls for {steps} rows")
    rerouted, earlier = [], False
    for i in range(steps):
        a = card_picks[i * layers:(i + 1) * layers]
        b = cpu_picks[i * layers:(i + 1) * layers]
        earlier = earlier or a[:-1] != b[:-1]
        rerouted.append(earlier or a[-1][-1] != b[-1][-1])
    wide = [i for i, e in enumerate(held["rel_err"]) if e > NEAR_TIE]
    log(f"{what}: rows past {NEAR_TIE} {wide}; rows a route of the "
        f"card's differs for {[i for i, r in enumerate(rerouted) if r]}")
    if any(not rerouted[i] for i in wide):
        raise AssertionError(f"{what}: rows {wide} leave the W4A8 "
                             f"spread with the same experts ({rerouted})")
    return dict(held, rerouted=rerouted)


def routed_parity(result: dict, variant) -> None:
    """moe_parity of a parity model (name, spec, CPU params, None), its
    prompt PARITY_PROMPT's or 64 tokens, into result["parity"][name]."""
    name, spec, params, _ = variant
    t0 = time.perf_counter()
    rec = moe_parity(name, spec, params, PARITY_PROMPT.get(name, 64))
    result.setdefault("parity", {})[name] = dict(
        rec, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


def bf16_experts_variant():
    """DeepSeek-V2-Lite at full width cut to 2 layers (one dense, one MoE)
    with unquantized float32 weights everywhere, experts included: the
    routed experts run the plain expert products (ops/moe.py PLAIN_KINDS)
    on both devices, the rest as the ``dense`` variant; held to
    PARITY_TOL."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    return "bf16_experts", spec, card_drawn(
        spec, quant="bf16", dtype=torch.float32), PARITY_TOL


# DeepSeek-V3 cut to 6 layers (3 dense, 3 MoE), W4A8 weights. A single-user
# step: dense_w4a8_matmul 19 (qkv_a = [q_a | kv_a], q_b and o_proj of 6
# layers, lm_head), dense_w4a8_ffn 6 (3 dense MLPs, I = 18432, and 3 shared
# experts, I = 2048: both have a chunk plan in the JAX package), the
# routed experts on the W4A8 matmuls, 2 x 3 (their blocks exceed the
# fused FFN's budget); activation preps where the routes do not fold (at
# prefill every 256-row call and the last-row lm_head: 31; at decode the
# lm_head GEMV, the dense MLP's one-row gate_up and the 8 routed rows'
# gate_up: 7)
V3_STEP_LAUNCHES = {
    "prefill_chunk": {"dense_w4a8_matmul": 19, "dense_w4a8_ffn": 6,
                      "grouped_w4a8_matmul": 6, "w4a8_prep": 31},
    "decode_step": {"dense_w4a8_matmul": 19, "dense_w4a8_ffn": 6,
                    "gathered_w4a8_matmul": 6, "mla_decode_fused": 6,
                    "w4a8_prep": 7},
}
# ... and the ServeEngine's steps: a decode batch of 8 (64 gathered rows;
# 22 preps: the 19 dense projections at 8 rows lie past the tensor-core
# fold crossover, the FFNs' 8 rows fold, the routed gate_up does not) and
# a mixed step (8 decode rows + one 256-token chunk: 31 preps)
V3_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"dense_w4a8_matmul": 19, "dense_w4a8_ffn": 6,
                             "gathered_w4a8_matmul": 6, "w4a8_prep": 22,
                             "mla_paged_decode": 6},
    "serve_mixed_step_b8_s256": {"dense_w4a8_matmul": 19,
                                 "dense_w4a8_ffn": 6,
                                 "grouped_w4a8_matmul": 6, "w4a8_prep": 31,
                                 "mla_paged_decode": 6,
                                 "mla_paged_prefill": 6},
}
# the near-tie of V3's W4A8 engine agreement: a logits row whose token the
# sigmoid router sends to another expert set moves by up to 1.0e-1 of the
# largest logit (moe_parity holds that only such rows leave NEAR_TIE), and
# the engine's batch of 8 rounds otherwise than the Generator's one row, so
# a top-2 gap of 5e-2 is no margin there. The engine itself is held at
# NEAR_TIE on V3 with int8 weights (v3_int8_engine), which have no
# activation codes to flip.
V3_NEAR_TIE = 1e-1
V3_SINGLE_USER_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "dense_w4a8_ffn",
                          "gathered_w4a8_matmul", "grouped_w4a8_matmul",
                          "mla_decode_fused")
V3_PAGED_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "dense_w4a8_ffn",
                    "gathered_w4a8_matmul", "grouped_w4a8_matmul",
                    "mla_paged_decode", "mla_paged_prefill")


def v3_serve(result: dict) -> None:
    """DeepSeek-V3 cut to 6 layers on the card, W4A8 (serve_model): launches
    per step held to V3_STEP_LAUNCHES / V3_ENGINE_STEP_LAUNCHES, the
    engine's tokens held to the Generator's at V3_NEAR_TIE."""
    serve_model(result, "v3", v3_cfg(), "int4_g", "int4_g",
                V3_SINGLE_USER_KERNELS, V3_PAGED_KERNELS, V3_STEP_LAUNCHES,
                V3_ENGINE_STEP_LAUNCHES, tie=V3_NEAR_TIE)


V3_INT8_SINGLE_USER_KERNELS = ("quant_matmul", "gathered_quant_matmul",
                               "grouped_quant_matmul", "mla_decode_fused")


def v3_int8_engine(result: dict) -> None:
    """DeepSeek-V3 cut to 6 layers with int8 weights everywhere (the
    quant_matmul kernels, rows 9-11, no int8 activation codes): a Generator
    answering one request of 512 + 32 tokens, then the ServeEngine's 8
    requests at depth 3 held to the Generator at NEAR_TIE, as
    DeepSeek-V2-Lite's int8 engine is. The engine path (paged MLA at 128
    heads with V3's softmax scale, batches, pages) is the W4A8 one; what
    the int8 weights take away is the activation codes that let the
    rounding order move the router."""
    gen = serve(result, quant="int8", key="serve_v3_int8", requests=1,
                expect=V3_INT8_SINGLE_USER_KERNELS, cfg=v3_cfg())
    paged_serve(result, gen, key="paged_serve_v3_int8", depths=(3,),
                expect=INT8_PAGED_KERNELS)
    del gen
    torch.cuda.empty_cache()


# --------------------------------------------------------------- HF import


def hf_tensors(spec, seed: int) -> dict:
    """HF-named float32 tensors ([out, in] for linear weights) of a
    DeepSeek spec (q_proj or q_a / q_a_layernorm / q_b, kv_a / kv_b, dense
    MLP or routed + shared experts with the router and, under noaux_tc, its
    correction bias), drawn on the host from one seeded generator: weights
    normal with std 1 / sqrt(in), norms near 1."""
    gen = torch.Generator().manual_seed(seed)
    a, d = spec.attention, spec.hidden_size
    h, nope, dr = a.num_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    out: dict = {}

    def lin(name, n_out, n_in):
        out[name] = torch.randn(n_out, n_in, generator=gen) / n_in ** 0.5

    def norm(name, n):
        out[name] = 1.0 + 0.1 * torch.randn(n, generator=gen)

    def mlp(pre, inter):
        lin(f"{pre}.gate_proj.weight", inter, d)
        lin(f"{pre}.up_proj.weight", inter, d)
        lin(f"{pre}.down_proj.weight", d, inter)

    out["model.embed_tokens.weight"] = 0.02 * torch.randn(
        spec.vocab_size, d, generator=gen)
    for li in range(spec.num_layers):
        pre = f"model.layers.{li}"
        sa = f"{pre}.self_attn"
        norm(f"{pre}.input_layernorm.weight", d)
        norm(f"{pre}.post_attention_layernorm.weight", d)
        if a.q_lora_rank:
            lin(f"{sa}.q_a_proj.weight", a.q_lora_rank, d)
            norm(f"{sa}.q_a_layernorm.weight", a.q_lora_rank)
            lin(f"{sa}.q_b_proj.weight", h * (nope + dr), a.q_lora_rank)
        else:
            lin(f"{sa}.q_proj.weight", h * (nope + dr), d)
        lin(f"{sa}.kv_a_proj_with_mqa.weight", a.kv_lora_rank + dr, d)
        norm(f"{sa}.kv_a_layernorm.weight", a.kv_lora_rank)
        lin(f"{sa}.kv_b_proj.weight", h * (nope + a.v_head_dim),
            a.kv_lora_rank)
        lin(f"{sa}.o_proj.weight", d, h * a.v_head_dim)
        m = spec.moe
        if m is not None and m.is_moe_layer(li):
            lin(f"{pre}.mlp.gate.weight", m.num_experts, d)
            if m.gate.has_correction_bias:
                out[f"{pre}.mlp.gate.e_score_correction_bias"] = \
                    0.1 * torch.rand(m.num_experts, generator=gen)
            for ex in range(m.num_experts):
                mlp(f"{pre}.mlp.experts.{ex}", m.moe_intermediate_size)
            if m.shared_expert_intermediate_size:
                mlp(f"{pre}.mlp.shared_experts",
                    m.shared_expert_intermediate_size)
        else:
            mlp(f"{pre}.mlp", spec.intermediate_size)
    norm("model.norm.weight", d)
    lin("lm_head.weight", spec.vocab_size, d)
    return out


def hf_module(tensors: dict) -> torch.nn.Module:
    """A plain nn.Module tree whose named_parameters() are ``tensors``
    under their HF names (no transformers)."""
    root = torch.nn.Module()
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(leaf, torch.nn.Parameter(t,
                                                        requires_grad=False))
    return root


# ---------------------------------------------------------------- front door

HTTP_NEW = PAGED_NEW_TOKENS
HTTP_STREAM = (1, 5)  # requests that stream (server-sent events)
HTTP_OLLAMA = 3  # the request sent to /api/generate
HTTP_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn", "dense_w4a8_ffn",
                "grouped_w4a8_ffn", "mla_paged_decode", "mla_paged_prefill")
CLI_LAYERS = 2
CLI_NEW = 16
CLI_PROMPTS = (64, 100)


def http_call(base: str, path: str, body=None, timeout: float = 300.0):
    """(status, JSON) of one request; GET without a body."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def id_list(text: str) -> list:
    """The ids of an IdTokenizer text."""
    return [int(t) for t in text.split()]


def http_request(base: str, kind: str, prompt: list, n: int) -> dict:
    """One request of the front-door run on the client's clock: a token-id
    /v1/completions ("plain", or "stream" with server-sent events), an
    /api/generate ("ollama") or a /v1/chat/completions ("chat") of the
    ids as IdTokenizer text. TTFT and the mean gap between tokens are
    taken where tokens arrive one at a time (streams); every request has
    its latency."""
    import urllib.request

    text = " ".join(map(str, prompt))
    t0 = time.perf_counter()
    out = dict(kind=kind, prompt_tokens=len(prompt))
    if kind == "stream":
        req = urllib.request.Request(
            base + "/v1/completions", headers={
                "Content-Type": "application/json"},
            data=json.dumps({"prompt": prompt, "max_tokens": n,
                             "stream": True}).encode())
        toks, stamps, finish = [], [], None
        with urllib.request.urlopen(req, timeout=300) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                got = id_list(choice["text"])
                if got:
                    toks += got
                    stamps.append(time.perf_counter())
                finish = choice["finish_reason"] or finish
        gaps = np.diff(stamps)
        out.update(ttft_s=stamps[0] - t0,
                   tbt_s=float(gaps.mean()) if len(gaps) else None)
    elif kind == "ollama":
        status, body = http_call(base, "/api/generate", {
            "prompt": text, "options": {"num_predict": n}})
        if status != 200:
            raise AssertionError(f"/api/generate: {status} {body}")
        toks, finish = id_list(body["response"]), body["done_reason"]
    else:
        chat = kind == "chat"
        status, body = http_call(
            base, "/v1/chat/completions" if chat else "/v1/completions",
            {"messages": [{"role": "user", "content": text}],
             "max_tokens": n} if chat else {"prompt": prompt,
                                            "max_tokens": n})
        if status != 200:
            raise AssertionError(f"{kind}: {status} {body}")
        choice = body["choices"][0]
        toks = id_list(choice["message"]["content"] if chat
                       else choice["text"])
        finish = choice["finish_reason"]
        if body["usage"]["completion_tokens"] != len(toks):
            raise AssertionError(f"{kind}: usage {body['usage']}")
    out.update(tokens=toks, finish_reason=finish,
               latency_s=time.perf_counter() - t0, done_at=time.perf_counter())
    return out


def hold_single_user(what: str, got: list, ref: list, gaps: list,
                     tie: float = NEAR_TIE):
    """Phase 6's rule: ``got`` equals the single-user tokens up to the
    first position whose top-2 gap lies below ``tie`` (a near-tie);
    returns that position or None."""
    diff = next((j for j in range(len(ref)) if got[j] != ref[j]), None)
    if len(got) != len(ref) or (diff is not None and gaps[diff] >= tie):
        raise AssertionError(f"{what} leaves the single-user tokens at "
                             f"{diff}: {got} vs {ref}")
    return diff


def http_serve(result: dict, gen) -> None:
    """The port's OpenAIServer (IdTokenizer) over a ServeEngine on phase
    6's parameters, on 127.0.0.1 at a free port: phase 6's 8 prompts from
    8 client threads at once (token-id /v1/completions, requests
    HTTP_STREAM streamed, request HTTP_OLLAMA through /api/generate) and a
    ninth thread's chat completion, HTTP_NEW greedy tokens each, every
    request's tokens held to the single-user Generator's by phase 6's
    rule; client-side TTFT, mean TBT, latency and the aggregate output
    tok/s beside the card; the launches of the run (counts set to 0 just
    before the first request), HTTP_KERNELS among them."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
    from ktransformers_tpu_torch.serving.server import (
        IdTokenizer,
        OpenAIServer,
    )

    t0 = time.perf_counter()
    vocab = gen.spec.vocab_size
    prompts = paged_prompts(vocab)
    prompts.append(np.random.default_rng(400).integers(0, vocab,
                                                       200).tolist())
    refs = list(result["paged_serve"]["single_user"])
    refs.append(single_user_reference(gen, prompts[8], HTTP_NEW))
    kinds = ["stream" if i in HTTP_STREAM else
             "ollama" if i == HTTP_OLLAMA else "plain" for i in range(8)]
    kinds.append("chat")
    eng = ServeEngine(gen.params, gen.spec, SchedulerConfig(),
                      num_pages=512, device="cuda")
    eng.generate_sync(list(range(8)), max_new_tokens=2)  # warm-up
    eng.reset_metrics()
    srv = OpenAIServer(eng, IdTokenizer())
    eng.start()
    base = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    try:
        status, health = http_call(base, "/health")
        if status != 200:
            raise AssertionError(f"/health: {status} {health}")
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(kinds)) as pool:
            futs = [pool.submit(http_request, base, k, p, HTTP_NEW)
                    for k, p in zip(kinds, prompts)]
            outs = [f.result() for f in futs]
        wall = max(o["done_at"] for o in outs) - start
        torch.cuda.synchronize()
        launches, routed_n = dict(LAUNCHES), dict(ROUTED_LAUNCHES)
        status, models = http_call(base, "/v1/models")
    finally:
        srv.stop()
        eng.stop()
    server_side = sorted((len(q.prompt), q.ttft, q.tbt)
                         for q in eng.scheduler.finished)
    diffs = []
    for i, (o, (ref, gaps)) in enumerate(zip(outs, refs)):
        if o["finish_reason"] != "length":
            raise AssertionError(f"http request {i}: {o}")
        diffs.append(hold_single_user(f"http request {i} ({o['kind']})",
                                      o["tokens"], ref, gaps))
        o.pop("done_at")
    tok_s = sum(len(o["tokens"]) for o in outs) / wall
    card = result["card"]
    for i, o in enumerate(outs):
        ttft = "" if "ttft_s" not in o else (
            f", ttft {o['ttft_s'] * 1e3:.1f} ms, mean tbt "
            f"{o['tbt_s'] * 1e3:.2f} ms")
        log(f"http request {i} ({o['kind']}, {o['prompt_tokens']} prompt "
            f"tokens): latency {o['latency_s'] * 1e3:.1f} ms{ttft}")
    log(f"http_serve ({card}): {len(outs)} requests, {tok_s:.1f} output "
        f"tok/s on the client's clock over {wall:.2f} s; "
        f"{sum(d is None for d in diffs)}/{len(outs)} equal the single-user "
        f"tokens, the rest first differ at a near-tie ({diffs}); launches "
        f"{json.dumps(launches)}")
    missing = [k for k in HTTP_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by http_serve: {missing}")
    result["http_serve"] = dict(
        card=card, requests=outs, wall_s=wall, output_tok_s=tok_s,
        first_diff=diffs, server_ttft_tbt=server_side, launches=launches,
        routed_launches=routed_n, models=models,
        seconds=time.perf_counter() - t0)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_start(args: list) -> subprocess.Popen:
    """``python -m ktransformers_tpu_torch.cli`` with ``args``, started
    from the checkout's root."""
    return subprocess.Popen(
        [sys.executable, "-m", "ktransformers_tpu_torch.cli", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def cli_finish(proc: subprocess.Popen, log_name: str,
               timeout: float = 600.0) -> str:
    """Wait for a cli_start process, its output into
    chiprun_out/<log_name>; returns stdout, raises on a failure."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(OUT_DIR, log_name), "w") as fh:
        fh.write(f"$ {' '.join(proc.args)}\n{out}\n{err}")
    if proc.returncode != 0:
        raise AssertionError(f"cli {proc.args[3]} exited {proc.returncode}: "
                             f"{err[-2000:]}")
    return out


def write_hf_dir(path: str, cfg: dict, tensors: dict) -> None:
    """An HF-style directory: config.json, two bf16 safetensors shards
    (the embedding and layer 0, then the rest) and their index, written
    with the port's writer."""
    from ktransformers_tpu_torch.loader.safetensors_io import save_file

    os.makedirs(path, exist_ok=True)
    first = {k for k in tensors
             if k.startswith(("model.embed_tokens", "model.layers.0."))}
    weight_map = {}
    for i, names in enumerate((sorted(first), sorted(set(tensors) - first))):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: tensors[k].to(torch.bfloat16) for k in names},
                  os.path.join(path, fname))
        weight_map.update({k: fname for k in names})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(cfg, fh)


def front_door_cli(result: dict) -> None:
    """The CLI end to end on DeepSeek-V2-Lite at full width cut to
    CLI_LAYERS (one dense, one MoE layer): HF-named tensors drawn on the
    host (hf_tensors) written as an HF directory (write_hf_dir); `convert`
    to a packed directory (int8, int4_g experts) through
    SafetensorsProvider; `doctor` (beside the two); `serve <packed>
    --tokenizer ids` as a
    process on a free port, polled on /health, answering CLI_PROMPTS one
    after the other (CLI_NEW greedy tokens), its tokens equal to an
    in-process ServeEngine's over load_params(<packed>) with the CLI's
    scheduler settings (run while the server starts). The packed tree
    loaded onto the card equals the CPU's bit for bit, and its logits card
    vs CPU hold moe_parity's rule.
    The server process is killed in a finally; its exit before that fails
    the run."""
    import tempfile

    from ktransformers_tpu_torch.models.checkpoint import load_params
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.serving import ServeEngine
    from ktransformers_tpu_torch.serving.config import ServerConfig
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    times = {}
    t0 = time.perf_counter()
    cfg = dict(bench_model_cfg(), num_hidden_layers=CLI_LAYERS)
    spec = spec_from_hf_config(cfg)
    prompts = [np.random.default_rng(500 + i).integers(
        0, spec.vocab_size, n).tolist() for i, n in enumerate(CLI_PROMPTS)]
    # doctor needs nothing of the others: it runs beside them
    doctor_proc = cli_start(["doctor"])
    with tempfile.TemporaryDirectory() as tmp:
        hf, packed = os.path.join(tmp, "hf"), os.path.join(tmp, "packed")
        write_hf_dir(hf, cfg, hf_tensors(spec, seed=13))
        times["write_hf"] = time.perf_counter() - t0
        t = time.perf_counter()
        cli_finish(cli_start(["convert", hf, packed, "--quant", "int8",
                              "--moe-quant", "int4_g"]),
                   "front_door_convert.log")
        times["convert"] = time.perf_counter() - t
        t = time.perf_counter()
        doctor = json.loads(cli_finish(doctor_proc, "front_door_doctor.log"))
        times["doctor_wait"] = time.perf_counter() - t
        if doctor["matmul_smoke"] != "ok" or any(
                v != "ok" for v in doctor["kernel_libraries"].values()):
            raise AssertionError(f"doctor: {doctor}")
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        sc = ServerConfig(num_pages=256, max_batch_size=8)
        args = ["serve", packed, "--host", "127.0.0.1", "--port", str(port),
                "--tokenizer", "ids", "--num-pages", str(sc.num_pages),
                "--max-batch-size", str(sc.max_batch_size)]
        t = time.perf_counter()
        served = []
        with open(os.path.join(OUT_DIR, "front_door_serve.log"), "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ktransformers_tpu_torch.cli", *args],
                stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT)
            try:
                # while the server starts: the packed tree on both devices
                # and the in-process engine's tokens on the same prompts
                card = load_params(packed, spec, "cuda")
                cpu = load_params(packed, spec, "cpu")
                leaves = list(zip(_leaves(card), _leaves(cpu)))
                differ = sum(not (a.dtype == b.dtype
                                  and torch.equal(a.cpu(), b))
                             for a, b in leaves)
                if differ:
                    raise AssertionError(
                        f"front door: {differ} of {len(leaves)} packed "
                        "leaves differ between the card and the CPU")
                eng = ServeEngine(card, spec, sc.scheduler_config(),
                                  num_pages=sc.num_pages, device="cuda")
                eng.decode_pipeline_depth = sc.decode_pipeline_depth
                local = [eng.generate_sync(p, max_new_tokens=CLI_NEW)
                         for p in prompts]
                del eng, card
                times["in_process"] = time.perf_counter() - t
                deadline = time.perf_counter() + 300
                while True:
                    if proc.poll() is not None:
                        raise AssertionError(
                            f"cli serve exited {proc.returncode} before "
                            "answering /health")
                    try:
                        if http_call(base, "/health", timeout=5)[0] == 200:
                            break
                    except OSError:
                        pass
                    if time.perf_counter() > deadline:
                        raise AssertionError("cli serve: no /health in 300 s")
                    time.sleep(0.5)
                times["serve_ready"] = time.perf_counter() - t
                for p in prompts:
                    status, body = http_call(base, "/v1/completions", {
                        "prompt": p, "max_tokens": CLI_NEW})
                    if status != 200:
                        raise AssertionError(f"cli serve: {status} {body}")
                    served.append(id_list(body["choices"][0]["text"]))
                if proc.poll() is not None:
                    raise AssertionError(
                        f"cli serve exited {proc.returncode}")
            finally:
                proc.kill()
                proc.wait(timeout=60)
        times["serve"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    log(f"front door cli: served {served}, in-process {local}")
    if served != local or any(len(x) != CLI_NEW for x in served):
        raise AssertionError(f"cli serve tokens {served} != the in-process "
                             f"engine's {local}")
    t = time.perf_counter()
    parity = moe_parity("front_door_cli", spec, prepare_params(cpu, spec), 16)
    times["parity"] = time.perf_counter() - t
    times["all"] = time.perf_counter() - t0
    log(f"front door cli: {len(leaves)} leaves equal card vs CPU; seconds "
        f"{json.dumps({k: round(v, 1) for k, v in times.items()})}")
    result["front_door_cli"] = dict(
        leaves=len(leaves), served=served, in_process=local, parity=parity,
        doctor=doctor, seconds=times)


def mixtral_run(result: dict, rows: list, entries: dict) -> None:
    """Mixtral-8x7B (GQA attention, experts too wide for the fused FFN):
    its kernels at its shapes, 2-layer parity with the served kinds, then
    MIXTRAL_LAYERS layers single-user and through the ServeEngine with
    launches per step held; the parameters are freed after."""
    mixtral_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    variant = [gqa_variant("mixtral_w4a8", mixtral_cfg())]
    routed_parity(result, variant[0])
    paged_parity_check(result, variant)
    del variant
    torch.cuda.empty_cache()
    serve_model(result, "mixtral",
                dict(mixtral_cfg(), num_hidden_layers=MIXTRAL_LAYERS),
                "int8", "int4_g",
                MIXTRAL_SINGLE_USER_KERNELS, MIXTRAL_PAGED_KERNELS,
                MIXTRAL_STEP_LAUNCHES, MIXTRAL_ENGINE_STEP_LAUNCHES)


# --------------------------------- zero points, per-channel groups, GGUF

# the W4A8 weights of GGUF checkpoints and per-channel int4: int4_gz at
# group 32 (Q4_K, Q4_1), at group 16 (Q2_K), int4 with one group of all K
ZP_KINDS = (("int4_gz", 32), ("int4_gz", 16), ("int4", 0))
ZP_ROWS = (1, 8, 256, 264)


def zp_tag(kind: str, gs: int) -> str:
    return f"{kind} g{gs}" if gs else f"{kind} per-channel"


def split_codes(outs):
    """(codes and scales, sums t and xs), each flattened to float."""
    return (torch.cat([v.float().flatten() for v in outs[:4]]),
            torch.cat([v.flatten() for v in outs[4:]]))


def ffn_entry_check(check, entry, x, gu, dn, label, sms, ids=None,
                    sizes=None, kernel_main=False):
    """Row 2 (gathered_w4a8_ffn, ``ids``) or row 4 (grouped_w4a8_ffn,
    ``sizes``) on 3-D gate_up [E, K, 2I] / down [E, I, K] through check():
    the route's kernels held to the plain version, folded = unfolded where
    the route folds, a one-row-tile call's gate_up half timed apart. Bound:
    x, the codes, scales and zero points of the experts the rows use, the
    output."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    r, d = x.shape
    e, inter = gu.data.shape[0], dn.in_features
    gs, gs_dn = MM.group_of(gu), MM.group_of(dn)
    hasz = gu.zeros is not None
    route = F.ffn_route(r, entry, gs, gs_dn, inter, d)
    per_expert = nbytes(*weight_parts(gu, 0), *weight_parts(dn, 0))
    if entry == "gathered":
        used = int(torch.unique(ids).numel())
        wrapper = lambda: F.gathered_w4a8_ffn(x, gu, dn, ids)  # noqa: E731
        plain = lambda: F.gathered_w4a8_ffn_ref(x, gu, dn, ids)  # noqa: E731
        launcher = lambda k=None, fo=None: F.gathered_launcher(  # noqa: E731
            x, gu, dn, ids, "silu", k, fo)
        folds = route == "gemv" and F.ffn_gemv_call_folds(
            r, e, inter, gs_dn, d, gs, sms)
    else:
        used = int((sizes > 0).sum())
        wrapper = lambda: F.grouped_w4a8_ffn(x, gu, dn, sizes)  # noqa: E731
        plain = lambda: F.grouped_w4a8_ffn_ref(x, gu, dn, sizes)  # noqa: E731
        launcher = lambda k=None, fo=None: F.grouped_launcher(  # noqa: E731
            x, gu, dn, sizes, "silu", k, fo)
        folds = F.ffn_folds(route, r, d, gs, hasz)
    check(f"{entry}_w4a8_ffn", label, 3e-2, wrapper, plain, launcher,
          used * per_expert + 2 * nbytes(x), 2 * r * 3 * d * inter,
          INT8_OPS_PER_S, iters=10, kernel_main=kernel_main,
          up=ffn_up(x, gu, dn, ids.long(), used)
          if route == "gemv" else None,
          fold=None if route == "split" else fold_pair(
              lambda fo: launcher(None, fo),
              lambda: MM.prep_activations(x, d, gu.group_size, hasz),
              folds, fold_fits(route, r, d, gs, hasz, F.FFN_MMA_STAGES,
                               256)),
          **routed(FFN_ROUTES, route, lambda: launcher("rows")))


def zero_point_kernel_checks(rows: list, entries: dict) -> None:
    """The W4A8 rows at DeepSeek-V2-Lite's widths for each of ZP_KINDS
    (the zero term, groups 32 and 16 on the tensor cores, a per-channel
    group: w4a8_core.cuh, w4a8_mma.cuh, w4a8_gemv.cuh, w4a8_ffn.cu) against
    their plain versions (see make_check: a second call bit-identical,
    folded = unfolded where the route folds; timed with the bound and the
    library call), rows of chip_smoke.json's kernel_rows labelled by kind.
    The kernels line's entries of the zero-term instantiations (W4A8_ZP)
    are the int4_gz g32 rows (GGUF Q4_K's) of the shapes the int4_g
    entries take: qkv_a at M = 1 (the GEMV) and 256 (the tensor-core
    kernel), the gathered FFN of 6 rows (the FFN GEMV) and the grouped FFN
    of 1536 rows (the FFN's tensor-core kernel); the block prep's
    (w4a8_prep_block_kernel) the per-channel prep at M = 264, K = 10944:
    - the prep with the zero term's sums at K = 2048 and 10944 (a
      per-channel group of 10944 takes the block prep);
    - row 1 at M = 1, 8, 256, 264: qkv_a 2048 -> 3648, and the layer-0
      down 10944 -> 2048 at M = 1 and 264;
    - row 3 (the shared experts, I = 2816) at the same M;
    - rows 7 and 2 (64 experts, 2048 -> 2 x 1408 -> 2048) at 6 and 48
      routed rows (1 and 8 tokens x top-6), rows 8 and 4 at 48, 1536 and
      1584 sorted rows (8, 256, 264 tokens) with torch._grouped_mm on the
      bf16-dequantized experts as row 8's library yardstick.
    A per-channel down group takes the FFN's "split" route (the gate_up
    matmul into a float32 plane, kt_w4a8_glu_prep, the down matmul)."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo, w4a8_prep

    dev = torch.device("cuda")
    zp_entries = {}  # the kernel_main rows, keyed by the kernel's name
    check = make_check(rows, zp_entries)
    rd, rn, _ = draw(4004)
    sms = MM.sm_count(dev)
    e, d, f, top = 64, 2048, 1408, 6
    g_cpu = torch.Generator().manual_seed(4)

    def routing(tokens):
        return torch.stack([torch.randperm(e, generator=g_cpu)[:top]
                            for _ in range(tokens)]).to(dev)

    t0 = time.perf_counter()
    for kind, gs in ZP_KINDS:
        tag = zp_tag(kind, gs)
        ent = (kind, gs) == ("int4_gz", 32)  # the kernels line's rows

        def w(shape):
            return repack_offset_lo(rd.q(shape, kind, gs))

        for m, k in ((1, d), (264, 10944)):
            x = rn(m, k)
            g = gs or k
            check("w4a8_prep", f"{tag} M={m} K={k}", 0.0,
                  lambda: split_codes(MM.prep_activations(x, k, gs, True)),
                  lambda: split_codes(w4a8_prep(x, k, gs)),
                  lambda: (lambda: MM.prep_activations(x, k, gs, True),
                           None),
                  nbytes(x) + m * k + 4 * m * (k // g) * 4, 0,
                  INT8_OPS_PER_S, side_tol=1e-5, iters=10,
                  expect=lambda: tuple(v.to(dev) for v in split_codes(
                      w4a8_prep(x.cpu(), k, gs))))
            if g > MM.PREP_WARP_MAX_GROUP and m == 264:
                entries["w4a8_prep_block_kernel"] = rows[-1]
        for k, n, what, ms in ((d, 3648, "qkv_a", ZP_ROWS),
                               (10944, d, "layer-0 down", (1, 264))):
            wt = w((k, n))
            for m in ms:
                dense_w4a8_check(
                    check, rn(m, k), wt, f"{tag} {what} {k}->{n} M={m}",
                    sms, kernel_main=ent and what == "qkv_a" and m in (1, 256))
            del wt
        sgu, sdn = w((d, 2 * 2816)), w((2816, d))
        for m in ZP_ROWS:
            dense_ffn_check(check, rn(m, d), sgu, sdn,
                            f"{tag} shared I=2816 M={m}", sms)
        del sgu, sdn
        gu, dn = w((e, d, 2 * f)), w((e, f, d))
        for tokens in (1, 8):
            ids = routing(tokens).reshape(-1).to(torch.int32)
            x = rn(ids.shape[0], d)
            label = f"{tag} {ids.shape[0]} rows ({tokens} tok x 6)"
            gathered_mm_check(check, x, gu, ids, label + " gate_up")
            ffn_entry_check(check, "gathered", x, gu, dn, label, sms,
                            ids=ids, kernel_main=ent and tokens == 1)
        wdq = dequant_experts(gu)
        for tokens in (8, 256, 264):
            sizes = torch.bincount(routing(tokens).reshape(-1),
                                   minlength=e).to(torch.int32)
            x = rn(tokens * top, d)
            label = f"{tag} {tokens * top} sorted rows ({tokens} tok x 6)"
            grouped_mm_check(check, x, gu, sizes, label + " gate_up",
                             library=grouped_mm(x, wdq, sizes))
            ffn_entry_check(check, "grouped", x, gu, dn, label, sms,
                            sizes=sizes, kernel_main=ent and tokens == 256)
        del gu, dn, wdq
        torch.cuda.empty_cache()
    for name, zp in zip(W4A8_REDESIGNED, W4A8_ZP):
        entries[zp] = zp_entries[name]
    log(f"zero-point kernel rows: {time.perf_counter() - t0:.1f} s")


# DeepSeek-V2-Lite's published shape (bench_model_cfg) cut to 4 layers for
# the GGUF phase: layer 0 dense, 1-3 MoE
# DeepSeek-V2-Lite's GGUF file cut to 3 layers: the dense layer 0, a MoE
# layer with Q4_1 experts' down and the last with Q8_0 ones (writing and
# loading the 4 it had took ~55 s of the script)
GGUF_LAYERS = 3
GGUF_SEED = 14


def gguf_fields(cfg: dict) -> dict:
    """llama.cpp metadata of a DeepSeek-V2 checkpoint (general.architecture
    deepseek2) for the config ``cfg``: what spec_from_gguf_fields reads."""
    a = "deepseek2"
    return {
        "general.architecture": a, "general.name": "DeepSeek-V2-Lite",
        f"{a}.block_count": cfg["num_hidden_layers"],
        f"{a}.embedding_length": cfg["hidden_size"],
        f"{a}.feed_forward_length": cfg["intermediate_size"],
        f"{a}.attention.head_count": cfg["num_attention_heads"],
        f"{a}.attention.head_count_kv": cfg["num_key_value_heads"],
        f"{a}.attention.layer_norm_rms_epsilon": cfg["rms_norm_eps"],
        f"{a}.rope.freq_base": cfg["rope_theta"],
        f"{a}.context_length": cfg["max_position_embeddings"],
        f"{a}.vocab_size": cfg["vocab_size"],
        f"{a}.expert_count": cfg["n_routed_experts"],
        f"{a}.expert_used_count": cfg["num_experts_per_tok"],
        f"{a}.expert_feed_forward_length": cfg["moe_intermediate_size"],
        f"{a}.expert_shared_count": cfg["n_shared_experts"],
        f"{a}.expert_weights_scale": cfg["routed_scaling_factor"],
        f"{a}.leading_dense_block_count": cfg["first_k_dense_replace"],
        f"{a}.attention.kv_lora_rank": cfg["kv_lora_rank"],
        f"{a}.attention.q_lora_rank": 0,
        f"{a}.rope.dimension_count": cfg["qk_rope_head_dim"],
        f"{a}.attention.key_length": cfg["qk_nope_head_dim"]
        + cfg["qk_rope_head_dim"],
        f"{a}.attention.value_length": cfg["v_head_dim"],
    }


def gguf_tensors(cfg: dict, rng) -> dict:
    """The checkpoint's tensors in ggml blocks from ``rng``
    (loader/gguf_writer.random_blocks: random codes, block scales that give
    each weight a standard deviation of 1 / sqrt(its input width), so that
    activations stay of order one): every matmul weight and the lm_head in
    Q4_K, as a Q4_K_M file holds them, where the input width is a multiple
    of the 256-value k-quant block; the layer-0 down (input 10944) and the
    routed experts' down (input 1408) are not, and there llama.cpp's Q4_K_M
    falls back to another block: here Q4_1 (int4_gz, group 32: the same
    W4A8 kernels), and Q8_0 (int8_g: the plain expert products, as in the
    JAX package) for the last MoE layer's experts' down, where a Q4_K_M
    file asks for Q6_K and falls back to Q8_0. The embedding in F16 (std
    1), norms ones and the router (std 1 / sqrt(hidden)) in F32."""
    from ktransformers_tpu_torch.loader.gguf_writer import random_blocks

    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    r, e = cfg["kv_lora_rank"], cfg["n_routed_experts"]
    inter, mi = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"] * mi
    layers = cfg["num_hidden_layers"]

    def blocks(tname, *shape):
        return random_blocks(rng, tname, shape, shape[-1] ** -0.5)

    def ones(n):
        return np.ones(n, np.float32)

    t = {"token_embd.weight": rng.standard_normal(
             (cfg["vocab_size"], d), dtype=np.float32).astype(np.float16),
         "output_norm.weight": ones(d),
         "output.weight": blocks("Q4_K", cfg["vocab_size"], d)}
    for li in range(layers):
        b = f"blk.{li}."
        t.update({
            b + "attn_norm.weight": ones(d), b + "ffn_norm.weight": ones(d),
            b + "attn_q.weight": blocks("Q4_K", h * (nope + rope), d),
            b + "attn_kv_a_mqa.weight": blocks("Q4_K", r + rope, d),
            b + "attn_kv_a_norm.weight": ones(r),
            b + "attn_kv_b.weight": blocks("Q4_K", h * (nope + v), r),
            b + "attn_output.weight": blocks("Q4_K", d, h * v),
        })
        if li < cfg["first_k_dense_replace"]:
            t.update({b + "ffn_gate.weight": blocks("Q4_K", inter, d),
                      b + "ffn_up.weight": blocks("Q4_K", inter, d),
                      b + "ffn_down.weight": blocks("Q4_1", d, inter)})
            continue
        down = "Q8_0" if li == layers - 1 else "Q4_1"
        t.update({
            b + "ffn_gate_inp.weight": (rng.standard_normal(
                (e, d), dtype=np.float32) * d ** -0.5),
            b + "ffn_gate_exps.weight": blocks("Q4_K", e, mi, d),
            b + "ffn_up_exps.weight": blocks("Q4_K", e, mi, d),
            b + "ffn_down_exps.weight": blocks(down, e, d, mi),
            b + "ffn_gate_shexp.weight": blocks("Q4_K", shared, d),
            b + "ffn_up_shexp.weight": blocks("Q4_K", shared, d),
            b + "ffn_down_shexp.weight": blocks("Q4_K", d, shared),
        })
    return t


# one dequantized sample a ggml type: (param path, GGUF name, expert or
# None, the fused gate||up half: 0 gate, 1 up, or None)
GGUF_SAMPLES = (
    (("layers", 0, "attn", "q_proj"), "blk.0.attn_q.weight", None, None),
    (("layers", 0, "mlp", "down"), "blk.0.ffn_down.weight", None, None),
    (("layers", 1, "moe", "experts", "gate_up"), "blk.1.ffn_up_exps.weight",
     5, 1),
    (("layers", GGUF_LAYERS - 1, "moe", "experts", "down"),
     f"blk.{GGUF_LAYERS - 1}.ffn_down_exps.weight", 7, None),
    (("lm_head",), "output.weight", None, None),
)


def gguf_sample_check(params, prov) -> dict:
    """dequantize of a sample of the repacked tensors (one a ggml type: a
    Q4_K attention weight, the Q4_1 layer-0 down, an expert's Q4_K up half
    of the fused gate_up, an expert's Q8_0 down, the Q4_K lm_head) against
    decode_ggml of the same blocks: within 1e-5 of the largest magnitude
    (the repack divides each Q4_K / Q4_1 min by its scale once)."""
    import dataclasses

    from ktransformers_tpu_torch.loader.gguf import decode_ggml
    from ktransformers_tpu_torch.quant.formats import dequantize

    out = {}
    for path, gname, expert, half in GGUF_SAMPLES:
        qt = params
        for k in path:
            qt = getattr(qt, k) if isinstance(k, str) and not isinstance(
                qt, (dict, list)) else qt[k]
        info = prov.gguf.info(gname)
        raw = prov.gguf.tensor_file[gname].raw(gname)
        shape = info.shape
        if expert is not None:
            per = raw.size // shape[0]
            raw, shape = raw[expert * per:(expert + 1) * per], shape[1:]
            pick = lambda t: None if t is None else t[expert]  # noqa: E731
            qt = dataclasses.replace(qt, data=qt.data[expert],
                                     scales=pick(qt.scales),
                                     zeros=pick(qt.zeros))
        ref = torch.from_numpy(decode_ggml(raw, info.ggml_type).reshape(
            shape).T.copy()).to(qt.data.device)
        got = dequantize(qt, torch.float32)
        if half is not None:
            n = got.shape[-1] // 2
            got = got[..., half * n:(half + 1) * n]
        mae, rel = rel_err(got, ref)
        log(f"gguf sample {gname}{'' if expert is None else f'[{expert}]'} "
            f"{qt.kind} g{qt.group_size}: dequantize vs decode_ggml "
            f"rel_err={rel:.2e}")
        if rel > 1e-5:
            raise AssertionError(f"gguf {gname}: the repack dequantizes to "
                                 f"other values ({rel})")
        out[gname] = dict(kind=qt.kind, group_size=qt.group_size,
                          rel_err=rel)
    return out


W4A8_WRAPPERS = ("dense_w4a8_matmul", "gathered_w4a8_matmul",
                 "grouped_w4a8_matmul")
W4A8_FFN_WRAPPERS = ("gathered_w4a8_ffn", "dense_w4a8_ffn",
                     "grouped_w4a8_ffn")
W4A8_REDESIGNED = ("w4a8_mma_kernel", "w4a8_gemv_kernel",
                   "w4a8_ffn_mma_kernel", "w4a8_ffn_gemv_kernel")
# their instantiations with the zero term (ops/cuda/w4a8_matmul.py:ZP)
W4A8_ZP = tuple(k + "<zp>" for k in W4A8_REDESIGNED)
# kernels of the kernels line that no main path runs, and why
OFF_MAIN_PATHS = {
    "w4a8_prep_block_kernel": "per-channel int4 weights only (a group of "
                              "all K); no GGUF block gives them",
}
GGUF_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn", "dense_w4a8_ffn",
                "grouped_w4a8_ffn", "gathered_w4a8_matmul",
                "grouped_w4a8_matmul", "mla_decode_fused")
GGUF_PAGED_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn",
                      "dense_w4a8_ffn", "grouped_w4a8_ffn",
                      "gathered_w4a8_matmul", "grouped_w4a8_matmul",
                      "mla_paged_decode", "mla_paged_prefill")


def hold_w4a8_routes(what: str, launches: dict, routed_n: dict,
                     zeros: bool = False) -> None:
    """Every W4A8 wrapper call of a run took redesigned kernels: each matmul
    call one, each FFN call two (its gate_up and down kernels, or a split
    call's two matmuls), so their sum equals the redesigned kernels'
    launches exactly when no call took a first version. With ``zeros``
    (every W4A8 weight of the run has zero points) only the kernels'
    instantiations with the zero term count."""
    calls = (sum(launches.get(k, 0) for k in W4A8_WRAPPERS)
             + 2 * sum(launches.get(k, 0) for k in W4A8_FFN_WRAPPERS))
    names = W4A8_ZP if zeros else W4A8_REDESIGNED + W4A8_ZP
    took = sum(routed_n.get(k, 0) for k in names)
    log(f"{what}: {calls} W4A8 kernel launches by the wrappers, "
        f"{took} on the redesigned kernels"
        + (" with the zero term" if zeros else ""))
    if calls != took:
        raise AssertionError(f"{what}: {calls - took} W4A8 launches took a "
                             "first version"
                             + (" or dropped the zero term" if zeros else ""))


def gguf_serve(result: dict) -> None:
    """A DeepSeek-V2-Lite GGUF checkpoint into the port on the card:
    gguf_tensors at the published widths, cut to GGUF_LAYERS layers,
    written with loader/gguf_writer.write_gguf to a temporary directory
    (deleted afterwards); spec_from_gguf_fields of its metadata equal to
    the config's spec; GGUFProvider + build_params(exact_gguf=True) onto
    the card (the file's codes and block scales as they are,
    quant/gguf_repack.py); gguf_sample_check; prepare_params (W4A8 on: the
    int4_gz weights take the W4A8 kernels with their zero term); parity
    card vs CPU on an 8-token prompt and 2 decode steps by moe_parity
    (greedy tokens equal except at a near-tie; a row further than
    NEAR_TIE must follow a token that took other experts on the card);
    then a Generator answering one request of 256 prompt + 32 new tokens
    (tok/s), the ServeEngine answering the 8 requests of phase 6 at depth
    3, and the four profiled steps (device busy and idle share); every W4A8
    call of both runs on a redesigned kernel (hold_w4a8_routes) and every
    W4A8 weight int4_gz with zero points."""
    import tempfile

    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.loader.gguf_writer import write_gguf
    from ktransformers_tpu_torch.loader.providers import GGUFProvider
    from ktransformers_tpu_torch.models.loading import build_params
    from ktransformers_tpu_torch.models.spec import (
        spec_from_gguf_fields,
        spec_from_hf_config,
    )
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    cfg = dict(bench_model_cfg(), num_hidden_layers=GGUF_LAYERS)
    rec: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp,
                            f"deepseek-v2-lite-{GGUF_LAYERS}l-q4_k.gguf")
        write_gguf(path, gguf_fields(cfg), gguf_tensors(
            cfg, np.random.default_rng(GGUF_SEED)))
        rec["file_bytes"] = os.path.getsize(path)
        rec["write_s"] = time.perf_counter() - t0
        log(f"gguf: wrote {rec['file_bytes'] / 1e9:.3f} GB in "
            f"{rec['write_s']:.1f} s")
        t1 = time.perf_counter()
        prov = GGUFProvider(path)
        spec = spec_from_gguf_fields(prov.fields())
        # GGUF keeps float metadata in float32
        f32 = {k: float(np.float32(cfg[k]))
               for k in ("rms_norm_eps", "rope_theta")}
        if spec != spec_from_hf_config(dict(cfg, **f32)):
            raise AssertionError("gguf: spec_from_gguf_fields differs from "
                                 "the config's spec")
        params = build_params(prov, spec, quant="int8", exact_gguf=True,
                              device="cuda")
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t1
        rec["samples"] = gguf_sample_check(params, prov)
        prov.gguf.close()
    log(f"gguf: built in {rec['build_s']:.1f} s")
    prepare_params(params, spec)
    w4 = [q for q in _qtensors(params) if q.act_quant]
    bad = [(q.kind, q.group_size) for q in w4
           if q.kind != "int4_gz" or q.zeros is None]
    if bad or not w4:
        raise AssertionError(f"gguf: W4A8 weights without zero points {bad}")
    rec["w4a8_weights"] = len(w4)

    # parity card vs CPU (moe_parity's rule)
    rec["parity"] = moe_parity("gguf", spec, params, 8)

    # single user: 256 prompt + 32 new tokens
    gen = Generator(params, spec, max_len=1024, batch=1, device="cuda")
    warm_generator(gen)
    torch.cuda.synchronize()
    reset_launches()
    prompt_ids = np.random.default_rng(140).integers(
        0, spec.vocab_size, 256).tolist()
    out, ttft, dec = timed_generate(gen, prompt_ids,
                                    GenerateConfig(max_new_tokens=32))
    if len(out) != 32:
        raise AssertionError(f"gguf: bad tokens {out}")
    launches, routed_n = dict(LAUNCHES), dict(ROUTED_LAUNCHES)
    hold_graphed("gguf single user", gen, prompt_ids, out)
    log(f"gguf single user: prefill {256 / ttft:.1f} tok/s (ttft "
        f"{ttft * 1e3:.1f} ms), decode {dec:.2f} tok/s; launches "
        f"{json.dumps(launches)}, redesigned {json.dumps(routed_n)}")
    missing = [k for k in GGUF_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"gguf single user: not launched {missing}")
    hold_w4a8_routes("gguf single user", launches, routed_n, zeros=True)
    result["serve_gguf"] = dict(prefill_tok_s=256 / ttft, ttft_s=ttft,
                                decode_tok_s=dec, tokens=out[:8],
                                launches=launches, routed_launches=routed_n)
    paged_serve(result, gen, key="paged_serve_gguf", depths=(3,),
                expect=GGUF_PAGED_KERNELS)
    run = result["paged_serve_gguf"]["runs"][3]
    hold_w4a8_routes("gguf paged serve", run["launches"],
                     run["routed_launches"], zeros=True)
    profile_steps(result, gen, prefix="gguf_")
    profile_engine_steps(result, gen, prefix="gguf_")
    for name in ("decode_step", "prefill_chunk", "serve_decode_step_b8",
                 "serve_mixed_step_b8_s256"):
        p = result["profile"]["gguf_" + name]
        log(f"gguf {name}: wall {p['wall_ms']:.3f} ms, device busy "
            f"{p['device_busy_ms']:.3f} ms, idle share {p['idle_share']}")
    rec["seconds"] = time.perf_counter() - t0
    result["gguf"] = rec
    del gen, params
    torch.cuda.empty_cache()


# ---------------------------------------------------- Qwen2-MoE / Qwen3-MoE

# Qwen2-57B-A14B's depth on the card: cut to 4 layers (depth only; the 28
# layers would take 34.7 GB and another two minutes of serving)
QWEN2_LAYERS = 4
# Qwen3-30B-A3B served at 8 of its 48 layers: the phases of the dense and
# GLM models took the time (it ran whole, 48 layers, until then; 12 until
# the host-offload phase)
QWEN3_LAYERS = 8


def qwen3_cfg(layers: int = QWEN3_LAYERS) -> dict:
    """Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json, the registry's
    preset): hidden 2048, 32 query heads over 4 KV heads of 128 with the
    per-head q / k norm, 128 experts of inter 768 top-8 renormalized, vocab
    151,936; cut from 48 to ``layers`` in depth only."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    return dict(REGISTRY["qwen3-30b-a3b"].config, num_hidden_layers=layers)


def qwen2_cfg(layers: int = QWEN2_LAYERS) -> dict:
    """Qwen2-57B-A14B (Qwen/Qwen2-57B-A14B-Instruct config.json, the
    registry's preset): hidden 3584, 28 query heads over 4 KV heads of 128
    with q / k / v biases, 64 experts of inter 2560 top-8 unnormalized, a
    shared expert of inter 20480 behind a sigmoid gate, vocab 151,936; cut
    to ``layers`` in depth only."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    return dict(REGISTRY["qwen2-57b-a14b"].config, num_hidden_layers=layers)


def int8_matmul_checks(check, rd, rn, weights) -> None:
    """Row 9 (quant_matmul) on int8 weights of (tag, K, N, what) at the M
    the served paths give them: 1 (single-user decode), 8 (the engine's
    decode batch) and 256 (a prefill chunk); an lm_head only 1 and 8 (it
    reads last rows). The kernel takes no bias: a fused QKV's ("... +
    bias") is added after it, as linear() adds it, the same bits. Bound
    over the bf16 peak (int8 weights meet bf16 activations on bf16 MMAs);
    torch.matmul on the bf16-dequantized weight the yardstick."""
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
    from ktransformers_tpu_torch.ops.linear import linear
    from ktransformers_tpu_torch.quant.formats import dequantize

    for tag, d, n, what in weights:
        wt = rd.q((d, n), "int8", 128)
        wdq = dequantize(wt, torch.bfloat16)
        for m in ((1, 8) if what == "lm_head" else (1, 8, 256)):
            x = rn(m, d)
            check("quant_matmul", f"{tag} int8 {what} {d}->{n} M={m}", 1e-2,
                  lambda: QM.quant_matmul(x, wt),
                  lambda: QM.quant_matmul_ref(x, wt),
                  lambda: QM.dense_launcher(x, wt),
                  nbytes(x, wt.data, wt.scales) + m * n * 2, 2 * m * n * d,
                  BF16_FLOPS_PER_S, library=lambda: torch.matmul(x, wdq),
                  **routed(QM_ROUTES, QM.route(x.dtype, m, "dense", "int8",
                                               d, n, QM.rows_per_group(wt)),
                           lambda: QM.dense_launcher(x, wt, "rows")))
            if what.endswith("bias"):
                b = rn(n)
                if not torch.equal(linear(x, wt, b),
                                   QM.quant_matmul(x, wt) + b):
                    raise AssertionError(f"{tag} qkv bias: linear() is not "
                                         "the kernel's product + bias")
        del wt, wdq
        torch.cuda.empty_cache()


def expert_mm_checks(check, w, rn, routing, tag: str, e: int, d: int,
                     f: int) -> None:
    """Rows 7 and 8 on e W4A8 experts d -> 2 x f -> d that the fused FFN's
    budget refuses, gate_up and down: gathered at 8 and 64 rows (one token
    and the engine's 8 tokens, top-8: ``routing(tokens)`` gives the expert
    ids [tokens, 8]), grouped at 2048 sorted rows (a 256-token chunk) with
    torch._grouped_mm on the bf16-dequantized experts as the yardstick."""
    from ktransformers_tpu_torch.quant.formats import dequantize

    for k, n, what in ((d, 2 * f, "gate_up"), (f, d, "down")):
        wt = w((e, k, n))
        for tokens, label in ((1, "decode 8 rows (1 tok x 8)"),
                              (8, "serve decode 64 rows (8 tok x 8)")):
            ids = routing(tokens).reshape(-1).to(torch.int32)
            gathered_mm_check(check, rn(ids.shape[0], k), wt, ids,
                              f"{tag} {label} {what} [{e}, {k}, {n}]")
        wdq = dequantize(wt, torch.bfloat16)
        sizes = torch.bincount(routing(256).reshape(-1),
                               minlength=e).to(torch.int32)
        x = rn(2048, k)
        grouped_mm_check(check, x, wt, sizes,
                         f"{tag} prefill 2048 rows (256 tok x 8) {what} "
                         f"[{e}, {k}, {n}]",
                         library=grouped_mm(x, wdq, sizes))
        del wt, wdq
        torch.cuda.empty_cache()


def qwen_kernel_checks(rows: list, entries: dict) -> None:
    """The kernels of the Qwen paths at their widths, bf16, against their
    plain versions (see make_check; none is a kernels-line entry):
    - row 9 (quant_matmul) on every int8 weight of the served kinds at
      M = 1, 8 and 256: the fused QKV (Qwen3 2048 -> 5120; Qwen2 3584 ->
      4608 with its bias added after the kernel), o_proj (4096 -> 2048,
      3584 -> 3584), Qwen2's shared expert (gate_up 3584 -> 40960, down
      20480 -> 3584), and the 151,936-wide lm_head at M = 1 and 8. Bound:
      bf16 operations, as for Mixtral's (int8 weights meet bf16
      activations on bf16 MMAs);
    - the W4A8 experts by the route the wrappers take: Qwen3's (128 of
      2048 -> 2 x 768 -> 2048) on the fused FFN, row 2 at 8 and 64 routed
      rows, row 4 at 2048 sorted rows (256 tokens x 8); Qwen2's (64 of
      3584 -> 2 x 2560 -> 3584), which the fused FFN's budget refuses, on
      rows 7 (8 and 64 rows) and 8 (2048 rows), gate_up and down;
    - row 3 (dense_w4a8_ffn) on Qwen2's shared expert as all-int4_g
      weights would have it (3584 -> 2 x 20480 -> 3584) at M = 1, 8 and
      256; the served kinds keep it int8 (row 9 above);
    - rows 13 and 15 at G = 8 (Qwen3: 32 over 4 KV heads) and G = 7
      (Qwen2: 28 over 4), gqa_cases_checks on GQA_SERVE_CASES.
    Routing draws top-8 of the experts from softmax scores of random
    logits."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    rd, rn, w = draw(1515)
    sms = MM.sm_count(dev)
    g_cpu = torch.Generator().manual_seed(15)

    def routing(tokens, e):
        logits = torch.randn(tokens, e, generator=g_cpu)
        return torch.topk(logits, 8, dim=-1).indices.to(dev)

    int8_matmul_checks(check, rd, rn, (
        ("qwen3", 2048, 5120, "qkv"),
        ("qwen3", 4096, 2048, "o_proj"),
        ("qwen3", 2048, 151936, "lm_head"),
        ("qwen2", 3584, 4608, "qkv + bias"),
        ("qwen2", 3584, 3584, "o_proj"),
        ("qwen2", 3584, 40960, "shared gate_up"),
        ("qwen2", 20480, 3584, "shared down"),
        ("qwen2", 3584, 151936, "lm_head")))

    # Qwen3's experts: the fused FFN (rows 2 and 4)
    e, d, f = 128, 2048, 768
    gu, dn = w((e, d, 2 * f)), w((e, f, d))
    for tokens, label in ((1, "decode 8 rows (1 tok x 8)"),
                          (8, "serve decode 64 rows (8 tok x 8)")):
        ids = routing(tokens, e).reshape(-1).to(torch.int32)
        ffn_entry_check(check, "gathered", rn(ids.shape[0], d), gu, dn,
                        f"qwen3 {label}, 128 experts {d}->2x{f}->{d}", sms,
                        ids=ids)
    sizes = torch.bincount(routing(256, e).reshape(-1),
                           minlength=e).to(torch.int32)
    ffn_entry_check(check, "grouped", rn(2048, d), gu, dn,
                    f"qwen3 prefill 2048 rows (256 tok x 8), 128 experts "
                    f"{d}->2x{f}->{d}", sms, sizes=sizes)
    del gu, dn

    # Qwen2's experts: rows 7 and 8
    d = 3584
    expert_mm_checks(check, w, rn, lambda t: routing(t, 64), "qwen2", 64, d,
                     2560)

    # row 3 on Qwen2's shared expert in int4_g (all-int4_g weights; the
    # served kinds keep it int8, on row 9 above)
    fs = 20480
    sgu, sdn = w((d, 2 * fs)), w((fs, d))
    for m in (1, 8, 256):
        dense_ffn_check(check, rn(m, d), sgu, sdn,
                        f"qwen2 shared int4_g I={fs}, M={m}", sms)
    del sgu, sdn
    torch.cuda.empty_cache()

    gqa_cases_checks(check, rn, 32, 4, 128, GQA_SERVE_CASES, "qwen3 ")
    gqa_cases_checks(check, rn, 28, 4, 128, GQA_SERVE_CASES, "qwen2 ")


QWEN3_SINGLE_USER_KERNELS = ("w4a8_prep", "quant_matmul",
                             "gathered_w4a8_ffn", "grouped_w4a8_ffn")
QWEN3_PAGED_KERNELS = QWEN3_SINGLE_USER_KERNELS + ("gqa_paged_decode",
                                                   "gqa_paged_prefill")
# Qwen3-30B-A3B, QWEN3_LAYERS MoE layers (L): quant_matmul 2 L + 1 (the
# fused qkv and o_proj of every layer, lm_head); the experts on the fused
# FFN, grouped at prefill (2048 sorted rows: one activation prep a call)
# and gathered at decode (8 rows on the one-row gate_up, which quantizes x
# itself: no prep); GQA attention plain PyTorch on the contiguous cache
_L3 = QWEN3_LAYERS
QWEN3_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 2 * _L3 + 1, "grouped_w4a8_ffn": _L3,
                      "w4a8_prep": _L3},
    "decode_step": {"quant_matmul": 2 * _L3 + 1, "gathered_w4a8_ffn": _L3},
}
# ... and on the paged path the GQA kernel once a layer: a decode batch of
# 8 (64 gathered rows, one a tile: still folded) and a mixed step (8 decode
# rows + one 256-token chunk: 2112 grouped rows, a prep each)
QWEN3_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 2 * _L3 + 1,
                             "gathered_w4a8_ffn": _L3,
                             "gqa_paged_decode": _L3},
    "serve_mixed_step_b8_s256": {"quant_matmul": 2 * _L3 + 1,
                                 "grouped_w4a8_ffn": _L3, "w4a8_prep": _L3,
                                 "gqa_paged_decode": _L3,
                                 "gqa_paged_prefill": _L3},
}
# Qwen2-57B-A14B cut to 4 MoE layers: quant_matmul 17 (the fused qkv with
# its bias, o_proj and the shared expert's gate_up and down of 4 layers,
# lm_head; the shared gate's sigmoid is plain PyTorch); the experts too
# wide for the fused FFN on the W4A8 matmuls, 2 a layer: grouped at
# prefill (a prep each), gathered at decode (8 rows fold, 64 do not)
QWEN2_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 17, "grouped_w4a8_matmul": 8,
                      "w4a8_prep": 8},
    "decode_step": {"quant_matmul": 17, "gathered_w4a8_matmul": 8},
}
QWEN2_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 17, "gathered_w4a8_matmul": 8,
                             "w4a8_prep": 8, "gqa_paged_decode": 4},
    "serve_mixed_step_b8_s256": {"quant_matmul": 17,
                                 "grouped_w4a8_matmul": 8, "w4a8_prep": 8,
                                 "gqa_paged_decode": 4,
                                 "gqa_paged_prefill": 4},
}


def serve_model(result: dict, name: str, cfg: dict, quant: str,
                moe_quant: str, single, paged, steps, engine_steps,
                tie: float = NEAR_TIE) -> None:
    """One model on the card (``quant`` weights, ``moe_quant`` routed
    experts): a Generator answering 2 requests of 512 + 32 tokens, the
    launches of a prefill chunk and a decode step held to ``steps``; a
    ServeEngine answering the 8 requests of phase 6 at depth 3 with phase
    6's checks (near-tie ``tie``); the four profiled steps, the engine's
    launches held to ``engine_steps``; then the parameters are freed.
    Results go under serve_<name>, <name>_step_launches,
    paged_serve_<name> and profile <name>_*."""
    gen = serve(result, quant=quant, moe_quant=moe_quant,
                key=f"serve_{name}", requests=2, expect=single, cfg=cfg)
    step_launches(result, gen, f"{name}_step_launches", steps)
    paged_serve(result, gen, key=f"paged_serve_{name}", depths=(3,),
                expect=paged, tie=tie)
    profile_steps(result, gen, prefix=f"{name}_")
    profile_engine_steps(result, gen, prefix=f"{name}_")
    got = {step: {k: v for k, v in
                  result["profile"][f"{name}_{step}"]["launches"].items()
                  if v}
           for step in engine_steps}
    log(f"{name} engine launches per step: {json.dumps(got)}")
    if got != engine_steps:
        raise AssertionError(f"{name} engine launches per step {got}, want "
                             f"{engine_steps}")
    del gen
    torch.cuda.empty_cache()


def qwen_run(result: dict, rows: list, entries: dict) -> None:
    """Qwen3-30B-A3B (per-head q / k norm, G = 8, the fused expert FFN)
    and Qwen2-57B-A14B (q / k / v biases, the gated shared expert, G = 7,
    the experts on rows 7-8): their kernels at their widths, 2-layer
    parity card vs CPU with the served kinds, then Qwen3 cut to
    QWEN3_LAYERS and Qwen2 cut to QWEN2_LAYERS served single-user and
    through the ServeEngine with launches per step held."""
    qwen_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    routed_parity(result, gqa_variant("qwen3_w4a8", qwen3_cfg()))
    routed_parity(result, gqa_variant("qwen2_w4a8", qwen2_cfg()))
    serve_model(result, "qwen3", qwen3_cfg(), "int8", "int4_g",
                QWEN3_SINGLE_USER_KERNELS, QWEN3_PAGED_KERNELS,
                QWEN3_STEP_LAUNCHES, QWEN3_ENGINE_STEP_LAUNCHES)
    # Qwen2's experts take Mixtral's route (rows 7-8, no fused FFN)
    serve_model(result, "qwen2", qwen2_cfg(), "int8", "int4_g",
                MIXTRAL_SINGLE_USER_KERNELS, MIXTRAL_PAGED_KERNELS,
                QWEN2_STEP_LAUNCHES, QWEN2_ENGINE_STEP_LAUNCHES)


# ------------------------------------------------------------ long context

LONG_MAX_LEN = 16384  # cache positions: past BLOCKWISE_KV_THRESHOLD
LONG_PROMPT = 9000
LONG_CHUNK = 256
LONG_NEW = 8
LONG_LAYERS = 2
# last-chunk logits, blockwise against dense: of the largest logit. Both
# paths compute float32 attention from the same bf16 cache; only the order
# of the softmax sums differs, so bf16 activations round apart now and then
LONG_TOL = 1e-2


def long_context_models():
    """(name, cfg, quant, moe_quant) of phase 18, full width cut to
    LONG_LAYERS, int8 weights (the quant_matmul kernels: no activation
    codes, which a rounding-order change in the attention would flip and
    so move a row by more than the paths differ): DeepSeek-V2-Lite with its
    published max_position_embeddings (163,840; the rope tables must reach
    9,008 positions); Llama-3.1-8B."""
    return (("v2_lite", dict(bench_model_cfg(), num_hidden_layers=LONG_LAYERS,
                             max_position_embeddings=163840),
             "int8", "int8"),
            ("llama", llama_cfg(LONG_LAYERS), "int8", "int8"))


def long_run(gen, prompt, late: int) -> dict:
    """prompt [1, S] prefilled through the Generator in LONG_CHUNK-token
    chunks, then LONG_NEW greedy tokens. The chunk that starts at ``late``
    is measured: its wall ms and the peak device memory it allocated above
    what was allocated before it. Returns the last chunk's last logits row
    (float32, CPU), the tokens, the top-2 gap before each token and the
    measurements."""
    cache = gen.new_cache()
    rec: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, prompt.shape[1], LONG_CHUNK):
        if start == late:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
        logits, cache = gen._forward(prompt[:, start : start + LONG_CHUNK],
                                     cache, logits_last_only=True)
        if start == late:
            torch.cuda.synchronize()
            rec["late_chunk_ms"] = (time.perf_counter() - t1) * 1e3
            rec["late_chunk_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                            - base)
            rec["late_chunk_peak_total_bytes"] = \
                torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    rec["prefill_s"] = time.perf_counter() - t0
    rec["logits"] = logits[:, -1].float().cpu()[0]
    t0 = time.perf_counter()
    rec["tokens"], rec["gaps"] = greedy_decode(gen, logits[:, -1], cache,
                                               LONG_NEW)
    torch.cuda.synchronize()
    rec["decode_tok_s"] = (LONG_NEW - 1) / (time.perf_counter() - t0)
    return rec


def long_context(result: dict) -> None:
    """Phase 18: a single-user Generator at max_len LONG_MAX_LEN prefills a
    seeded LONG_PROMPT-token prompt in 256-token chunks and decodes
    LONG_NEW greedy tokens, on each model of long_context_models, twice on
    the same weights: on the blockwise path (the cache buffer past
    BLOCKWISE_KV_THRESHOLD: MLA prefill on mla_absorbed_blockwise, GQA
    prefill and decode on mha_blockwise; counted) and with the threshold
    set above max_len (the dense mla_absorbed / mha over the whole
    buffer). The last chunk's logits are held within LONG_TOL of the
    dense path's largest logit, the tokens equal up to a near-tie of the
    dense path (NEAR_TIE); the peak memory and time of the last full
    chunk on both paths are recorded."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.models import model as tmodel
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops import attention

    out = {}
    for name, cfg, quant, moe_quant in long_context_models():
        t0 = time.perf_counter()
        spec = spec_from_hf_config(cfg)
        gen = Generator(init_params_synthetic(spec, seed=0, quant=quant,
                                              moe_quant=moe_quant,
                                              device="cuda"),
                        spec, max_len=LONG_MAX_LEN, device="cuda")
        prompt = torch.as_tensor(np.random.default_rng(1800).integers(
            0, spec.vocab_size, (1, LONG_PROMPT)), device="cuda")
        late = (LONG_PROMPT // LONG_CHUNK - 1) * LONG_CHUNK
        blockwise = ("mla_absorbed_blockwise" if spec.attention.kind == "mla"
                     else "mha_blockwise")
        real, calls = getattr(tmodel, blockwise), [0]

        def counted(*a, **kw):
            calls[0] += 1
            return real(*a, **kw)

        runs = {}
        for path, threshold in (("blockwise",
                                 attention.BLOCKWISE_KV_THRESHOLD),
                                ("dense", LONG_MAX_LEN + 1)):
            old = attention.BLOCKWISE_KV_THRESHOLD
            attention.BLOCKWISE_KV_THRESHOLD = threshold
            setattr(tmodel, blockwise, counted)
            calls[0] = 0
            try:
                runs[path] = long_run(gen, prompt, late)
            finally:
                attention.BLOCKWISE_KV_THRESHOLD = old
                setattr(tmodel, blockwise, real)
            runs[path]["blockwise_calls"] = calls[0]
        b, d = runs["blockwise"], runs["dense"]
        err = float((b["logits"] - d["logits"]).abs().max()
                    / d["logits"].abs().max())
        diff = next((j for j in range(LONG_NEW)
                     if b["tokens"][j] != d["tokens"][j]), None)
        # a GQA model attends blockwise at every chunk and decode step, an
        # MLA model at every chunk (its decode runs the fused kernel)
        chunks = -(-LONG_PROMPT // LONG_CHUNK)
        want = spec.num_layers * (chunks + (LONG_NEW - 1
                                            if blockwise == "mha_blockwise"
                                            else 0))
        rec = dict(model=cfg["model_type"], quant=quant, layers=spec.num_layers,
                   max_len=LONG_MAX_LEN, prompt=LONG_PROMPT, rel_err=err,
                   tol=LONG_TOL, first_token_diff=diff,
                   gap=None if diff is None else d["gaps"][diff],
                   seconds=time.perf_counter() - t0,
                   **{p: {k: v for k, v in r.items() if k != "logits"}
                      for p, r in runs.items()})
        out[name] = rec
        log(f"long context {name}: {LONG_PROMPT} tokens into a "
            f"{LONG_MAX_LEN}-position cache, blockwise vs dense last-chunk "
            f"logits rel_err {err:.3e} (tol {LONG_TOL}); tokens "
            f"{b['tokens']} / {d['tokens']}; late chunk peak "
            f"{b['late_chunk_peak_bytes'] / 1e6:.1f} / "
            f"{d['late_chunk_peak_bytes'] / 1e6:.1f} MB above the "
            f"allocated, {b['late_chunk_ms']:.1f} / {d['late_chunk_ms']:.1f}"
            f" ms; prefill {b['prefill_s']:.2f} / {d['prefill_s']:.2f} s, "
            f"decode {b['decode_tok_s']:.1f} / {d['decode_tok_s']:.1f} tok/s;"
            f" {blockwise} calls {b['blockwise_calls']} / "
            f"{d['blockwise_calls']}")
        if b["blockwise_calls"] != want or d["blockwise_calls"]:
            raise AssertionError(f"long context {name}: {blockwise} ran "
                                 f"{b['blockwise_calls']} / "
                                 f"{d['blockwise_calls']} times, want {want}"
                                 " / 0")
        if not bool(torch.isfinite(b["logits"]).all()) or err > LONG_TOL:
            raise AssertionError(f"long context {name}: blockwise logits "
                                 f"{err:.3e} from the dense path's")
        if diff is not None and d["gaps"][diff] >= NEAR_TIE:
            raise AssertionError(f"long context {name}: tokens leave the "
                                 f"dense path's at {diff}, top-2 gap "
                                 f"{d['gaps'][diff]:.3e}")
        del gen
        torch.cuda.empty_cache()
    result["long_context"] = out


# ---------------------------------------------------- dense and GLM models

# GLM-4.5-Air served at 4 of its 46 layers: the dense layer and 3 MoE
# layers (all 46 would be ~61 GB with the float32 embedding)
GLM_LAYERS = 4


def llama_cfg(layers: int | None = None) -> dict:
    """Llama-3.1-8B (meta-llama/Llama-3.1-8B-Instruct config.json, the
    registry's preset): 32 layers, hidden 4096, 32 query heads over 8 KV
    heads of 128 (G = 4), dense MLP of inter 14336, vocab 128,256, rope
    theta 500,000 with HF's llama3 scaling; cut to ``layers`` in depth
    only where given."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    cfg = dict(REGISTRY["llama-3.1-8b"].config)
    if layers:
        cfg["num_hidden_layers"] = layers
    return cfg


def glm_cfg(layers: int = GLM_LAYERS) -> dict:
    """GLM-4.5-Air (zai-org/GLM-4.5-Air config.json, the registry's
    preset, with the published attention_bias: q / k / v biases): hidden
    4096, 96 query heads over 8 KV heads of 128 (G = 12) with rope over 64
    of them and the q / k norm, a dense first layer of inter 10944, 128
    experts of inter 1408 top-8 (sigmoid, correction bias) and one shared
    expert, vocab 151,552; cut from 46 to ``layers`` in depth only."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    return dict(REGISTRY["glm-4.5-air"].config, attention_bias=True,
                num_hidden_layers=layers)


def dense_glm_kernel_checks(rows: list, entries: dict) -> None:
    """The kernels of the Llama and GLM paths at their widths, bf16,
    against their plain versions (see make_check; none is a kernels-line
    entry):
    - row 9 (quant_matmul) on every int8 weight of the served kinds at
      M = 1, 8 and 256 (the lm_heads at 1 and 8): Llama's fused QKV (4096
      -> 6144), o_proj (4096 -> 4096), gate_up (4096 -> 28672), down
      (14336 -> 4096), lm_head (-> 128,256); GLM's fused QKV with its bias
      (4096 -> 14336), o_proj (12288 -> 4096), the dense layer's gate_up
      (4096 -> 21888) and down (10944 -> 4096), the shared expert's
      gate_up (4096 -> 2816) and down (1408 -> 4096), lm_head (->
      151,552); bound over the bf16 peak, as for Mixtral's and Qwen's;
    - GLM's experts (128 of 4096 -> 2 x 1408 -> 4096, int4_g repacked) on
      the route the wrappers take: the fused FFN's budget refuses them, so
      rows 7 (8 and 64 gathered rows) and 8 (2048 sorted rows), gate_up
      and down, with torch._grouped_mm on the bf16-dequantized experts as
      row 8's yardstick;
    - row 3 (dense_w4a8_ffn) on GLM's shared expert (I = 1408) and dense
      MLP (I = 10944) as all-int4_g weights would have them, M = 1, 8, 256
      (the served kinds keep both int8: row 9 above);
    - rows 13 and 15 at G = 12 (96 query heads over 8), gqa_cases_checks
      on GQA_SERVE_CASES.
    Routing draws top-8 of 128 from random logits."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    rd, rn, w = draw(1619)
    sms = MM.sm_count(dev)
    g_cpu = torch.Generator().manual_seed(19)
    int8_matmul_checks(check, rd, rn, (
        ("llama", 4096, 6144, "qkv"),
        ("llama", 4096, 4096, "o_proj"),
        ("llama", 4096, 28672, "gate_up"),
        ("llama", 14336, 4096, "down"),
        ("llama", 4096, 128256, "lm_head"),
        ("glm", 4096, 14336, "qkv + bias"),
        ("glm", 12288, 4096, "o_proj"),
        ("glm", 4096, 21888, "dense gate_up"),
        ("glm", 10944, 4096, "dense down"),
        ("glm", 4096, 2816, "shared gate_up"),
        ("glm", 1408, 4096, "shared down"),
        ("glm", 4096, 151552, "lm_head")))

    # GLM's experts: rows 7 and 8
    d = 4096

    def routing(tokens):
        logits = torch.randn(tokens, 128, generator=g_cpu)
        return torch.topk(logits, 8, dim=-1).indices.to(dev)

    expert_mm_checks(check, w, rn, routing, "glm", 128, d, 1408)

    # row 3 on GLM's shared expert and dense MLP in int4_g
    for inter, what in ((1408, "shared"), (10944, "dense MLP")):
        sgu, sdn = w((d, 2 * inter)), w((inter, d))
        for m in (1, 8, 256):
            dense_ffn_check(check, rn(m, d), sgu, sdn,
                            f"glm {what} int4_g I={inter}, M={m}", sms)
        del sgu, sdn
        torch.cuda.empty_cache()

    gqa_cases_checks(check, rn, 96, 8, 128, GQA_SERVE_CASES, "glm ")


LLAMA_SINGLE_USER_KERNELS = ("quant_matmul",)
LLAMA_PAGED_KERNELS = ("quant_matmul", "gqa_paged_decode",
                       "gqa_paged_prefill")
# Llama-3.1-8B served at LLAMA_LAYERS of its 32 layers (served whole until
# the SmallThinker / Qwen3-Next phase took the time, at 16 until the
# host-offload phase did)
LLAMA_LAYERS = 8
_LL = LLAMA_LAYERS
# Llama, L dense int8 layers: quant_matmul 4 L + 1 (the fused qkv, o_proj,
# gate_up and down of every layer, lm_head); no W4A8 weight, so no prep;
# GQA attention plain PyTorch on the contiguous cache
LLAMA_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 4 * _LL + 1},
    "decode_step": {"quant_matmul": 4 * _LL + 1},
}
# ... and the GQA paged kernels once a layer on the engine's steps
LLAMA_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 4 * _LL + 1,
                             "gqa_paged_decode": _LL},
    "serve_mixed_step_b8_s256": {"quant_matmul": 4 * _LL + 1,
                                 "gqa_paged_decode": _LL,
                                 "gqa_paged_prefill": _LL},
}
# GLM-4.5-Air cut to GLM_LAYERS (1 dense + 3 MoE): quant_matmul 17 (the
# fused qkv with its bias and o_proj of 4 layers, the dense layer's gate_up
# and down, the 3 shared experts' gate_up and down, lm_head); the experts
# too wide for the fused FFN on the W4A8 matmuls, 2 a MoE layer: grouped at
# prefill (2048 rows, a prep each), gathered at decode (8 rows: both
# fold); GQA attention plain PyTorch on the contiguous cache
GLM_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 17, "grouped_w4a8_matmul": 6,
                      "w4a8_prep": 6},
    "decode_step": {"quant_matmul": 17, "gathered_w4a8_matmul": 6},
}
# ... the engine's batch of 8 gathers 64 rows: the gate_up GEMV keeps its
# prep there (w4a8_matmul.gemv_folds), the down folds; a mixed step's 2112
# grouped rows a prep each; the GQA paged kernels once a layer
GLM_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 17, "gathered_w4a8_matmul": 6,
                             "w4a8_prep": 3, "gqa_paged_decode": 4},
    "serve_mixed_step_b8_s256": {"quant_matmul": 17,
                                 "grouped_w4a8_matmul": 6, "w4a8_prep": 6,
                                 "gqa_paged_decode": 4,
                                 "gqa_paged_prefill": 4},
}


def dense_glm_run(result: dict, rows: list, entries: dict) -> None:
    """Phase 19: Llama-3.1-8B (dense, int8, G = 4, llama3 rope) and
    GLM-4.5-Air (half rotary, q / k norm, QKV biases, G = 12, sigmoid
    router, experts on rows 7-8): their kernels at their widths, 2-layer
    parity card vs CPU (Llama's int8 weights held to FORMAT_TOL on every
    row; GLM's served kinds by moe_parity), then Llama cut to
    LLAMA_LAYERS and GLM to GLM_LAYERS served single-user and through the
    ServeEngine with launches per step held."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    dense_glm_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    spec = spec_from_hf_config(llama_cfg(2))
    parity_check(result, [("llama_int8", spec, card_drawn(spec, quant="int8"),
                           FORMAT_TOL)])
    routed_parity(result, gqa_variant("glm_w4a8", glm_cfg()))
    torch.cuda.empty_cache()
    serve_model(result, "llama", llama_cfg(LLAMA_LAYERS), "int8", "int8",
                LLAMA_SINGLE_USER_KERNELS, LLAMA_PAGED_KERNELS,
                LLAMA_STEP_LAUNCHES, LLAMA_ENGINE_STEP_LAUNCHES)
    # GLM's experts take Mixtral's route (rows 7-8, no fused FFN)
    serve_model(result, "glm", glm_cfg(), "int8", "int4_g",
                MIXTRAL_SINGLE_USER_KERNELS, MIXTRAL_PAGED_KERNELS,
                GLM_STEP_LAUNCHES, GLM_ENGINE_STEP_LAUNCHES)


# ------------------------------- SmallThinker-21B and Qwen3-Next (phase 20)

# SmallThinker-21B served at SMALLTHINKER_LAYERS of its 52 layers (16 until
# the host-offload phase took the time): a multiple of 4 keeps its layouts
# (every 4th layer NoPE and unwindowed, the others windowed at 4,096 keys)
SMALLTHINKER_LAYERS = 8
# Qwen3-Next-80B-A3B at QNEXT_LAYERS of its 48: its first layer_types, 3
# GatedDeltaNet layers and 1 gated full-attention layer
QNEXT_LAYERS = 4
WINDOW = 4096  # SmallThinker's sliding_window_size
WINDOW_PROMPT = 4608  # the seeded prompt's tokens: past the window
WINDOW_MAX_LEN = 5120  # the Generator's cache; the engine's pages a query
F32_TIE = 2 * PARITY_TOL  # float32 weights: a near-tie of hold_rows' rule


def smallthinker_cfg(layers: int = SMALLTHINKER_LAYERS) -> dict:
    """SmallThinker-21B (PowerInfer/SmallThinker-21BA3B-Instruct, the
    registry's preset): hidden 2560, 28 query heads over 4 KV heads of 128
    (G = 7), every 4th layer NoPE and unwindowed, the others windowed at
    4,096 keys; 64 ReLU-GLU experts of inter 768 top-6 behind the early
    router (sigmoid, no renormalization); vocab 151,936; cut to ``layers``
    in depth only, the layouts with it."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    cfg = REGISTRY["smallthinker-21b"].config
    return dict(cfg, num_hidden_layers=layers,
                rope_layout=cfg["rope_layout"][:layers],
                sliding_window_layout=cfg["sliding_window_layout"][:layers])


def qnext_cfg(layers: int = QNEXT_LAYERS) -> dict:
    """Qwen3-Next-80B-A3B (Qwen/Qwen3-Next-80B-A3B-Instruct, the registry's
    preset): hidden 2048; GatedDeltaNet layers of 16 key heads and 32 value
    heads of 128, conv 4; gated full attention of 16 query heads over 2 KV
    heads of 256 (G = 8) with rope over 64 and the q / k norm; 512 experts
    of inter 512 top-10 renormalized and a gated shared expert of 512;
    vocab 151,936; cut to ``layers`` in depth only, layer_types with it."""
    from ktransformers_tpu_torch.models.registry import REGISTRY

    cfg = REGISTRY["qwen3-next-80b-a3b"].config
    return dict(cfg, num_hidden_layers=layers,
                layer_types=cfg["layer_types"][:layers])


def hybrid_window_kernel_checks(rows: list, entries: dict) -> None:
    """Rows 13 and 15 on the two new shapes (gqa_cases_checks; none is a
    kernels-line entry):
    - head dim 256 at Qwen3-Next's 16 query heads over 2 KV heads (G = 8):
      decode B = 1 and 8 at 512 and 4,608 cached keys, a 256-token chunk
      after 256; bf16 on the redesigned kernels, float32 (B = 8 at 512, the
      chunk) on the first versions;
    - SmallThinker's G = 7 (28 over 4 of 128) at window 4,096, past it:
      decode B = 8 at 4,608 and 8,200 keys (and 1, 4,097, 4,096), chunks of
      256 after 4,352 and after 7,944 (the keys before each window NaN)."""
    check = make_check(rows, entries)
    _, rn, _ = draw(2020)
    for dtype, cases in (
            (torch.bfloat16, [("decode", [512], 0), ("decode", [4608], 0),
                              ("decode", [512] * 8, 0),
                              ("decode", [4608] * 8, 0),
                              ("prefill", [256], [256], 0)]),
            (torch.float32, [("decode", [512] * 8, 0),
                             ("prefill", [256], [256], 0)])):
        gqa_cases_checks(check, rn, 16, 2, 256, cases, "qwen3-next ", dtype)
    gqa_cases_checks(check, rn, 28, 4, 128, [
        ("decode", [4608, 8200, 1, 4097, 4096, 4608, 8200, 700], WINDOW),
        ("prefill", [4352], [256], WINDOW),
        ("prefill", [7944], [256], WINDOW)], "smallthinker ")


def f32_engine_check(result: dict, name: str, cfg: dict, prompts: list,
                     new_tokens: int = 8) -> None:
    """``cfg`` with float32 weights (plain expert products on the card) in
    a float32 Generator and ServeEngine (batch 8, its pages WINDOW_MAX_LEN
    a query): every prompt's greedy tokens from the engine equal the
    single-user Generator's up to a float32 near-tie (F32_TIE of the
    largest logit), the paged GQA kernels' float32 routes and the linear
    layers' slot states against the contiguous cache."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

    t0 = time.perf_counter()
    spec = spec_from_hf_config(cfg)
    params = init_params_synthetic(spec, seed=7, quant="bf16",
                                   dtype=torch.float32, device="cuda")
    f32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
               device="cuda")
    gen = Generator(params, spec, max_len=WINDOW_MAX_LEN, **f32)
    eng = ServeEngine(gen.params, spec, SchedulerConfig(
        max_pages_per_query=WINDOW_MAX_LEN // 64), num_pages=256, **f32)
    qs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    while any(q.state != "done" for q in qs):
        if not eng.step():
            break
    firsts = []
    for i, (p, q) in enumerate(zip(prompts, qs)):
        ref, gaps = single_user_reference(gen, p, new_tokens)
        got = list(q.output_ids)
        diff = next((j for j in range(len(ref)) if got[j] != ref[j]), None)
        firsts.append(diff)
        if diff is not None and gaps[diff] >= F32_TIE:
            raise AssertionError(f"{name} float32 engine request {i} leaves "
                                 f"the single-user tokens at {diff} (gap "
                                 f"{gaps[diff]:.2e}): {got} vs {ref}")
    rec = dict(prompt_tokens=[len(p) for p in prompts], first_diff=firsts,
               mixed_steps_fused=eng.mixed_steps_fused,
               seconds=time.perf_counter() - t0)
    log(f"{name} float32 engine vs single user: {len(prompts)} prompts of "
        f"{rec['prompt_tokens']} tokens, first differing token {firsts} "
        f"(None: all {new_tokens} equal), {eng.mixed_steps_fused} fused "
        f"mixed steps, {rec['seconds']:.1f} s")
    result.setdefault("f32_engine", {})[name] = rec
    del gen, eng, params
    torch.cuda.empty_cache()


SMALLTHINKER_SINGLE_USER_KERNELS = ("w4a8_prep", "quant_matmul",
                                    "gathered_w4a8_ffn", "grouped_w4a8_ffn")
SMALLTHINKER_PAGED_KERNELS = SMALLTHINKER_SINGLE_USER_KERNELS + (
    "gqa_paged_decode", "gqa_paged_prefill")
_LS = SMALLTHINKER_LAYERS
# SmallThinker cut to SMALLTHINKER_LAYERS MoE layers (L): quant_matmul
# 2 L + 1 (the fused qkv and o_proj of every layer, lm_head); the ReLU
# experts on the fused FFN, grouped at prefill (1536 sorted rows: a prep a
# call) and gathered at decode (6 rows on the one-row gate_up, which
# quantizes x itself: no prep); attention plain PyTorch on the contiguous
# cache (windows as masks)
SMALLTHINKER_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": 2 * _LS + 1, "grouped_w4a8_ffn": _LS,
                      "w4a8_prep": _LS},
    "decode_step": {"quant_matmul": 2 * _LS + 1, "gathered_w4a8_ffn": _LS},
}
# ... and on the paged path the GQA kernels once a layer, each with its
# layer's window: a batch of 8 (48 gathered rows) and a mixed step (8
# decode rows + one 256-token chunk: 1584 grouped rows, a prep each).
# Predicted before the first card run without a prep at the batch of 8 (as
# Qwen3-30B-A3B's); the card showed one a layer: at hidden 2560 a row holds
# 20 scale groups, past the 16 (row, group) units a folding GEMV block
# quantizes (w4a8_matmul.FOLD_MAX_UNITS), where Qwen3's 2048 hold 16
SMALLTHINKER_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": 2 * _LS + 1,
                             "gathered_w4a8_ffn": _LS, "w4a8_prep": _LS,
                             "gqa_paged_decode": _LS},
    "serve_mixed_step_b8_s256": {"quant_matmul": 2 * _LS + 1,
                                 "grouped_w4a8_ffn": _LS, "w4a8_prep": _LS,
                                 "gqa_paged_decode": _LS,
                                 "gqa_paged_prefill": _LS},
}
QNEXT_SINGLE_USER_KERNELS = SMALLTHINKER_SINGLE_USER_KERNELS
QNEXT_PAGED_KERNELS = SMALLTHINKER_PAGED_KERNELS
_LQ = QNEXT_LAYERS
# Qwen3-Next cut to QNEXT_LAYERS (3 linear + 1 full, all MoE):
# quant_matmul 17 (each linear layer's in_proj_qkvz and out_proj, the full
# layer's fused gated qkv and o_proj, the 4 shared experts' gate_up and
# down, lm_head; in_proj_ba is bf16, a plain matmul); the experts on the
# fused FFN as SmallThinker's (2560 grouped rows at prefill, 10 gathered
# at decode)
_QMM = 2 * (_LQ - 1) + 2 + 2 * _LQ + 1
QNEXT_STEP_LAUNCHES = {
    "prefill_chunk": {"quant_matmul": _QMM, "grouped_w4a8_ffn": _LQ,
                      "w4a8_prep": _LQ},
    "decode_step": {"quant_matmul": _QMM, "gathered_w4a8_ffn": _LQ},
}
# ... and on the paged path the GQA kernels at the one full layer: a batch
# of 8 (80 gathered rows, folded); no fused mixed step for a hybrid model:
# the step's decode and its chunk run as two passes
QNEXT_ENGINE_STEP_LAUNCHES = {
    "serve_decode_step_b8": {"quant_matmul": _QMM, "gathered_w4a8_ffn": _LQ,
                             "gqa_paged_decode": 1},
    "serve_split_step_b8_s256": {"quant_matmul": 2 * _QMM,
                                 "gathered_w4a8_ffn": _LQ,
                                 "grouped_w4a8_ffn": _LQ, "w4a8_prep": _LQ,
                                 "gqa_paged_decode": 1,
                                 "gqa_paged_prefill": 1},
}
# the launches of one GatedDeltaNet layer's recurrence over a 256-token
# chunk, predicted before the first card run: ~10 a position
QNEXT_SCAN_LAUNCHES_PREDICTED = 2560


def hold_engine_steps(result: dict, name: str, want: dict) -> None:
    got = {step: {k: v for k, v in
                  result["profile"][f"{name}_{step}"]["launches"].items()
                  if v}
           for step in want}
    log(f"{name} engine launches per step: {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{name} engine launches per step {got}, want "
                             f"{want}")


def recurrence_share(result: dict, gen) -> None:
    """Where Qwen3-Next's prefill chunk (256 tokens after 256) goes: its
    wall time with the GatedDeltaNet recurrences (gated_delta_scan)
    synchronized around and timed on the host's clock, their share of it,
    and the device kernels of one recurrence alone over the chunk's shapes
    (torch.profiler)."""
    from ktransformers_tpu_torch.ops import linear_attention as tla

    prompt = torch.as_tensor(np.random.default_rng(210).integers(
        0, gen.spec.vocab_size, (1, 512)), device=gen.device)
    scan, spent, shapes = tla.gated_delta_scan, [], []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        shapes.append(a)
        return out

    walls = []
    tla.gated_delta_scan = timed
    try:
        for _ in range(3):
            cache = gen.new_cache()
            gen.prefill(cache, prompt[:, :256])
            spent.clear()
            walls.append((wall_ms(lambda: gen.prefill(cache,
                                                      prompt[:, 256:])),
                          sum(spent) * 1e3, len(spent)))
    finally:
        tla.gated_delta_scan = scan
    wall, scan_ms, calls = sorted(walls)[1]
    rows = kernel_rows(lambda: scan(*shapes[-1]))
    kernels = sum(r[2] for r in rows)
    rec = dict(chunk_wall_ms=wall, scan_ms=scan_ms, scan_calls=calls,
               share=scan_ms / wall, scan_device_ms=sum(r[1] for r in rows),
               scan_kernels=kernels,
               scan_kernels_predicted=QNEXT_SCAN_LAUNCHES_PREDICTED,
               top=[dict(name=k[:90], ms=ms, count=n)
                    for k, ms, n in rows[:6]])
    log(f"qnext recurrence: a 256-token chunk {wall:.1f} ms wall, the "
        f"{calls} recurrences {scan_ms:.1f} ms of it ({rec['share']:.1%}); "
        f"one recurrence alone {rec['scan_device_ms']:.3f} ms device in "
        f"{kernels} kernels (predicted {QNEXT_SCAN_LAUNCHES_PREDICTED})")
    result["qnext_recurrence"] = rec


def hybrid_window_run(result: dict, rows: list, entries: dict) -> None:
    """Phase 20: SmallThinker-21B (NoPE and windowed layers, the early
    router, ReLU experts) and Qwen3-Next-80B-A3B (GatedDeltaNet layers,
    gated attention at head dim 256): rows 13 / 15 at D = 256 and past a
    window; 2-layer (SmallThinker) and 4-layer (Qwen3-Next) parity card vs
    CPU with the served kinds by moe_parity; the ServeEngine against the
    single-user Generator on float32 weights at 4 layers; then SmallThinker
    cut to SMALLTHINKER_LAYERS with a 4,608-token prompt through the
    Generator and the ServeEngine, and Qwen3-Next cut to QNEXT_LAYERS in a
    Generator and a ServeEngine at batch 8 whose waves reuse a slot;
    launches per step held to SMALLTHINKER_* / QNEXT_*, the recurrence's
    share of Qwen3-Next's chunk recorded."""
    hybrid_window_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    routed_parity(result, gqa_variant("smallthinker_w4a8",
                                      smallthinker_cfg(2)))
    routed_parity(result, gqa_variant("qnext_w4a8", qnext_cfg(4)))
    vocab = smallthinker_cfg()["vocab_size"]
    long_prompt = np.random.default_rng(4608).integers(
        0, vocab, WINDOW_PROMPT).tolist()
    f32_engine_check(result, "smallthinker", smallthinker_cfg(4),
                     [long_prompt, long_prompt[:300], long_prompt[-77:]])
    f32_engine_check(result, "qnext", qnext_cfg(4),
                     [long_prompt[:600], long_prompt[:300],
                      long_prompt[-77:]])

    # SmallThinker: the 4,608-token prompt single-user and in the engine
    from ktransformers_tpu_torch.serving import SchedulerConfig

    sched = SchedulerConfig(max_pages_per_query=WINDOW_MAX_LEN // 64)
    gen = serve(result, quant="int8", moe_quant="int4_g",
                key="serve_smallthinker", requests=2,
                expect=SMALLTHINKER_SINGLE_USER_KERNELS,
                cfg=smallthinker_cfg(), max_len=WINDOW_MAX_LEN,
                prompt_lens=[WINDOW_PROMPT, 512])
    step_launches(result, gen, "smallthinker_step_launches",
                  SMALLTHINKER_STEP_LAUNCHES)
    prompts = paged_prompts(vocab)
    prompts[0] = long_prompt
    prompts[4][:256] = long_prompt[:256]
    paged_serve(result, gen, key="paged_serve_smallthinker", depths=(3,),
                expect=SMALLTHINKER_PAGED_KERNELS, prompts=prompts,
                sched=sched, reroutes=True)
    profile_steps(result, gen, prefix="smallthinker_")
    profile_engine_steps(result, gen, prefix="smallthinker_")
    hold_engine_steps(result, "smallthinker",
                      SMALLTHINKER_ENGINE_STEP_LAUNCHES)
    del gen
    torch.cuda.empty_cache()

    # Qwen3-Next: single user, the engine's waves, the recurrence's share
    gen = serve(result, quant="int8", moe_quant="int4_g", key="serve_qnext",
                requests=2, expect=QNEXT_SINGLE_USER_KERNELS,
                cfg=qnext_cfg())
    step_launches(result, gen, "qnext_step_launches", QNEXT_STEP_LAUNCHES)
    paged_serve(result, gen, key="paged_serve_qnext", depths=(3,),
                expect=QNEXT_PAGED_KERNELS)
    profile_steps(result, gen, prefix="qnext_")
    profile_engine_steps(result, gen, prefix="qnext_")
    hold_engine_steps(result, "qnext", QNEXT_ENGINE_STEP_LAUNCHES)
    recurrence_share(result, gen)
    del gen
    torch.cuda.empty_cache()


# ------------------------------------------------- routed experts on host

# DeepSeek-V2-Lite with its routed experts in host memory (int4_g, all 27
# layers, full width): two requests of OFFLOAD_PROMPT + OFFLOAD_NEW tokens
# single-user, four through the HostOffloadServeEngine
OFFLOAD_PROMPT = 256
OFFLOAD_NEW = 16
OFFLOAD_ENGINE_NEW = 8  # new tokens of each engine request
OFFLOAD_HOST_ROWS = (1, 8, 256)
OFFLOAD_HOST_TOL = 1e-4  # host FFN against the plain float32 product
# launches per offloaded step, predicted before the first card run: the
# card runs the 57 dense projections (qkv_a and o_proj of 27 layers, the
# layer-0 MLP's gate_up and down, lm_head), the 26 shared-expert FFN calls
# and the attention of 27 layers, and no routed-expert kernel. At 2 and 4
# rows every W4A8 call quantizes x inside its kernel (w4a8_matmul.folds,
# w4a8_ffn.ffn_folds) but the layer-0 down (group 96 at K = 10944, past the
# folded A tile): one prep. A 2 x 256-row chunk folds only lm_head (its
# last 2 rows): 54 + 2 + 26 preps. Attention of a contiguous-cache chunk
# is plain PyTorch.
OFFLOAD_STEP_LAUNCHES = {
    "prefill_chunk_b2_s256": {"dense_w4a8_matmul": 57,
                              "dense_w4a8_ffn": 26, "w4a8_prep": 82},
    "decode_step_b2": {"dense_w4a8_matmul": 57, "dense_w4a8_ffn": 26,
                       "mla_decode_fused": 27, "w4a8_prep": 1},
    "serve_decode_step_b4": {"dense_w4a8_matmul": 57, "dense_w4a8_ffn": 26,
                             "mla_paged_decode": 27, "w4a8_prep": 1},
}
OFFLOAD_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "dense_w4a8_ffn",
                   "mla_decode_fused")
SHARED_RANGE = "offload::shared_expert"  # offload_profile's annotation
OFFLOAD_PAGED_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "dense_w4a8_ffn",
                         "mla_paged_decode", "mla_paged_prefill")


def launch_diff(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def near_tie_hold(what: str, got: list, ref: list, gaps: list):
    """Phase 6's rule: tokens ``got`` equal ``ref`` up to the first
    position whose top-2 gap in the reference lies below NEAR_TIE of its
    largest logit; returns that first difference (None: all equal)."""
    diff = next((j for j in range(len(ref)) if got[j] != ref[j]), None)
    if diff is not None and gaps[diff] >= NEAR_TIE:
        raise AssertionError(f"{what} leaves the single-user tokens at "
                             f"{diff} (top-2 gap {gaps[diff]:.3e}): {got} vs "
                             f"{ref}")
    return diff


def host_info() -> dict:
    """The card's host: cores, RAM, OpenMP and torch threads."""
    from ktransformers_tpu_torch.offload.host_moe import openmp_max_threads

    mem = None
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                mem = int(line.split()[1]) * 1024
    return dict(cpu_count=os.cpu_count(), mem_total_bytes=mem,
                openmp_max_threads=openmp_max_threads(),
                torch_threads=torch.get_num_threads())


def host_ffn_check(layer, gate_up, down, spec) -> dict:
    """One layer's HostMoELayer at OFFLOAD_HOST_ROWS rows, top-k of its
    experts, against the plain float32 expert product on the card
    (moe_forward_dense_reference on the same int4_g codes), held within
    OFFLOAD_HOST_TOL of the largest value; host ms, median of 3."""
    from ktransformers_tpu_torch.ops.gate import route
    from ktransformers_tpu_torch.ops.moe import (
        MoEWeights,
        moe_forward_dense_reference,
    )

    out = {}
    for t in OFFLOAD_HOST_ROWS:
        g = torch.Generator(device="cuda").manual_seed(t)
        x = torch.randn(t, spec.hidden_size, device="cuda", generator=g)
        logits = torch.randn(t, spec.moe.num_experts, device="cuda",
                             generator=g)
        ids, w = route(logits, spec.moe.gate)
        ref = moe_forward_dense_reference(x, MoEWeights(gate_up, down), ids,
                                          w, spec.activation).cpu()
        args = (x.cpu(), ids.cpu().contiguous(), w.cpu().contiguous())
        got = layer.forward(*args)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            layer.forward(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        err = float((got - ref).abs().max() / ref.abs().max())
        out[t] = dict(rel_err=err, host_ms=statistics.median(times))
        log(f"offload host FFN T = {t}: rel_err {err:.2e} "
            f"(held to {OFFLOAD_HOST_TOL}), {out[t]['host_ms']:.3f} ms on "
            f"{layer.threads} threads")
        if not err <= OFFLOAD_HOST_TOL:
            raise AssertionError(f"host FFN at T = {t}: {err}")
    return out


def offload_greedy(gen, prompts: list, n: int) -> dict:
    """n greedy tokens of equal-length prompts through forward_chunk (one
    prefill chunk, then one token a step): tokens, top-2 gaps and logits
    rows per prompt, the launches of the chunk and of the first decode
    step, prefill and decode tok/s on the host's clock."""
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES

    b = len(prompts)
    cache = gen.new_cache(b)
    toks = torch.tensor(prompts, device=gen.device)
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, logits, cache = gen.forward_chunk(toks, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chunk = launch_diff(before, LAUNCHES)
    rows, outs, step = [logits.float().cpu()], [tok], None
    for _ in range(n - 1):
        before = dict(LAUNCHES)
        tok, logits, cache = gen.forward_chunk(tok[:, None], cache)
        step = step or launch_diff(before, LAUNCHES)
        rows.append(logits.float().cpu())
        outs.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows = torch.stack(rows, dim=1)  # [B, n, V]
    top2 = torch.topk(rows, 2, dim=-1).values
    gaps = ((top2[..., 0] - top2[..., 1]) / rows.abs().amax(-1)).tolist()
    return dict(tokens=torch.stack(outs, 1).cpu().tolist(), gaps=gaps,
                rows=rows, cache=cache, last=tok, chunk_launches=chunk,
                step_launches=step,
                prefill_tok_s=b * len(prompts[0]) / (t1 - t0),
                decode_tok_s=b * (n - 1) / (t2 - t1))


def offload_profile(gen, cache, tok) -> dict:
    """One decode step of the offloaded Generator under torch.profiler:
    wall (mean of 4 unprofiled steps), device busy and idle share, host ms
    per layer hop, and the share of the shared experts' device time that
    falls inside the host hops (their device ranges, annotated here
    around models/model.py's _dense_mlp calls on the shared experts,
    against the hops' host ranges on the profiler's common clock; None
    where the trace has no device range of the annotation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ktransformers_tpu_torch.models import model
    from ktransformers_tpu_torch.offload.host_engine import HOP_RANGE

    state = {"tok": tok}

    def step():
        state["tok"], _, _ = gen.forward_chunk(state["tok"][:, None], cache)

    wall = wall_ms(lambda: [step() for _ in range(4)]) / 4
    shared_ids = {id(lp["moe"]["shared"]) for lp in gen.params["layers"]
                  if "moe" in lp and lp["moe"].get("shared") is not None}
    dense_mlp = model._dense_mlp

    def annotated(p, spec, x):
        if id(p) not in shared_ids:
            return dense_mlp(p, spec, x)
        with record_function(SHARED_RANGE):
            return dense_mlp(p, spec, x)

    torch.cuda.synchronize()
    model._dense_mlp = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        model._dense_mlp = dense_mlp
    events = list(prof.events())
    names = (HOP_RANGE, SHARED_RANGE)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in names and e.time_range.elapsed_us() > 0]
    hops = [(e.time_range.start, e.time_range.end) for e in events
            if e.name == HOP_RANGE and e.device_type == DeviceType.CPU]
    shared = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == SHARED_RANGE and e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

    def inside(a0, a1):
        return sum(max(0, min(a1, h1) - max(a0, h0)) for h0, h1 in hops)

    shared_us = sum(b - a for a, b in shared)
    overlap = (sum(inside(a, b) for a, b in shared) / shared_us
               if shared_us else None)
    hop_ms = [(b - a) / 1e3 for a, b in hops]
    busy_in_hops = sum(inside(e.time_range.start, e.time_range.end)
                       for e in kernels) / 1e3
    prof.export_chrome_trace(os.path.join(OUT_DIR,
                                          "offload_decode_trace.json"))
    out = dict(wall_ms=wall, device_busy_ms=busy,
               idle_share=1.0 - busy / wall, device_kernels=len(kernels),
               hops=len(hops), hop_ms_mean=statistics.mean(hop_ms),
               hop_ms_max=max(hop_ms), hop_ms_sum=sum(hop_ms),
               device_busy_in_hops_ms=busy_in_hops,
               shared_device_ms=shared_us / 1e3 if shared else None,
               shared_inside_hop_share=overlap)
    log(f"offload profile decode step (batch {cache.lengths.shape[0]}): "
        f"wall {wall:.3f} ms, device busy {busy:.3f} ms in {len(kernels)} "
        f"kernels, idle {out['idle_share']:.3f}; {len(hops)} host hops of "
        f"{out['hop_ms_mean']:.3f} ms mean ({out['hop_ms_sum']:.3f} ms in "
        f"all, the card busy {busy_in_hops:.3f} ms inside them); shared "
        f"experts {out['shared_device_ms']} ms on the card, {overlap} of it "
        "inside a hop")
    if len(hops) != gen.spec.num_layers - 1:
        raise AssertionError(f"{len(hops)} host hops in a decode step")
    return out


def offload_engine(result: dict, dev, host, spec, prompts: list,
                   refs: list) -> None:
    """Four requests through the HostOffloadServeEngine at a batch of 4
    (request 1 submitted once request 0 has finished, so that the 128
    tokens it shares with request 0 hit the prefix cache), each held to its
    single-user tokens by phase 6's rule (near_tie_hold); launches of the
    run and of a decode step, and the fused mixed steps taken."""
    from ktransformers_tpu_torch.offload import HostOffloadServeEngine
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.serving import SchedulerConfig

    num_pages = 64
    eng = HostOffloadServeEngine(
        dev, spec, SchedulerConfig(max_batch_size=4, max_pages_per_query=8),
        host_layers=host, num_pages=num_pages, device="cuda")
    steps: list = []
    decode_step = eng._decode_step

    def counted(st, penalized):
        before = dict(LAUNCHES)
        out = decode_step(st, penalized)
        steps.append(launch_diff(before, LAUNCHES))
        return out

    eng._decode_step = counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    qs = {i: eng.submit(prompts[i], max_new_tokens=OFFLOAD_ENGINE_NEW)
          for i in (0, 2, 3)}
    while len(qs) < 4 or any(q.state != "done" for q in qs.values()):
        if not eng.step() and len(qs) == 4:
            break
        if 1 not in qs and qs[0].state == "done":
            qs[1] = eng.submit(prompts[1],
                               max_new_tokens=OFFLOAD_ENGINE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    result["paged_serve_offload"] = dict(
        launches=dict(LAUNCHES), routed_launches=dict(ROUTED_LAUNCHES),
        wall_s=wall, output_tok_s=4 * OFFLOAD_ENGINE_NEW / wall,
        engine_steps=eng.steps_executed,
        mixed_steps_fused=eng.mixed_steps_fused,
        matched_len=[qs[i].matched_len for i in range(4)],
        tokens=[list(qs[i].output_ids) for i in range(4)],
        decode_step_launches=steps[0] if steps else None)
    rec = result["paged_serve_offload"]
    log(f"offload engine: 4 requests in {wall:.2f} s, "
        f"{rec['output_tok_s']:.2f} output tok/s, {eng.steps_executed} "
        f"steps ({eng.mixed_steps_fused} fused mixed), matched "
        f"{rec['matched_len']}, launches "
        f"{json.dumps({k: v for k, v in rec['launches'].items() if v})}")
    if rec["matched_len"][1] != 128:
        raise AssertionError(f"offload engine: request 1 matched "
                             f"{rec['matched_len'][1]}")
    held = eng.prefix.stats()["nodes"]
    if eng.alloc.free_count + held != num_pages - 1:
        raise AssertionError("offload engine: pages leaked")
    verdicts = [near_tie_hold(f"offload engine request {i}",
                              rec["tokens"][i], ref, gaps)
                for i, (ref, gaps) in enumerate(refs)]
    rec["agreement"] = verdicts
    log(f"offload engine against single-user: {verdicts}")
    missing = [k for k in OFFLOAD_PAGED_KERNELS if rec["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"offload engine launched none of {missing}")


def offload_parity(result: dict) -> None:
    """DeepSeek-V2-Lite's full width cut to 2 layers (one dense, one MoE;
    int4_g drawn on the card, card_drawn): the HostOffloadGenerator on the
    card against the same run on the CPU (a 32-token prefill and 2 decode
    steps on fixed tokens, float32 compute and hops), held by moe_parity's
    rule with the routes recorded."""
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.offload import HostOffloadGenerator

    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    params = card_drawn(spec, prepare=False)
    feed = [t % spec.vocab_size for t in (11, 2222)]
    prompt = np.random.default_rng(3).integers(0, spec.vocab_size, (1, 32))

    def rows_on(device):
        gen = HostOffloadGenerator(params, spec, max_len=64, batch=1,
                                   cache_dtype=torch.float32,
                                   compute_dtype=torch.float32,
                                   device=device)
        cache = gen.new_cache()
        _, lg, cache = gen.forward_chunk(torch.as_tensor(prompt), cache)
        rows = [lg.float().cpu()]
        for tok in feed:
            _, lg, cache = gen.forward_chunk(torch.tensor([[tok]]), cache)
            rows.append(lg.float().cpu())
        return torch.cat(rows)

    t0 = time.perf_counter()
    card, card_picks = routes_of(lambda: rows_on("cuda"))
    cpu, cpu_picks = routes_of(lambda: rows_on("cpu"))
    result["offload"]["parity"] = dict(
        hold_routed("parity offload (card vs CPU)", card, card_picks, cpu,
                    cpu_picks), seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()


def forced_spread(gen, prompt: list, toks: list, routes) -> float:
    """What bf16 rounding alone moves ``gen``'s single-user steps by
    (model_steps over ``prompt`` and ``toks``, ``routes`` forced on every
    router call): the largest row error of its float32 compute and cache
    against its own compute dtype, as a share of the row's largest
    logit."""
    ref, _ = model_steps(gen, prompt, toks, forced=routes)
    dtypes = gen.compute_dtype, gen.cache_dtype
    gen.compute_dtype = gen.cache_dtype = torch.float32
    try:
        f32, _ = model_steps(gen, prompt, toks, forced=routes)
    finally:
        gen.compute_dtype, gen.cache_dtype = dtypes
    return float(((f32 - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


def offload_vs_resident(res, host, prompt: list, toks: list) -> dict:
    """The offloaded model (float32 hops, the host FFN in float32) against
    the resident Generator ``res`` (KT_W4A8=0: the routed experts on row
    10 in bf16) on the same device tensors, fed ``prompt`` and then
    ``toks`` (model_steps): the resident steps run under the routes the
    offloaded run took, so that the two differ by rounding alone, and
    every row is held by hold_rows to SPREAD_FACTOR times the resident
    model's bf16 rounding spread under the same routes (forced_spread)."""
    from ktransformers_tpu_torch.offload import HostOffloadGenerator

    off = HostOffloadGenerator(res.params, res.spec, host,
                               max_len=res.max_len, batch=1,
                               transfer_dtype=None, device="cuda")
    rows, routes = model_steps(off, prompt, toks)
    del off
    spread = forced_spread(res, prompt, toks, routes)
    ref, _ = model_steps(res, prompt, toks, forced=routes)
    held = hold_rows(rows.cpu(), ref.cpu(), "offload (float32 hops) against "
                     "the resident Generator (KT_W4A8=0) under the "
                     "offloaded routes", SPREAD_FACTOR * spread)
    return dict(held, spread=spread, routes=routes,
                max_rel_err=max(held["rel_err"]))


def streamed_check(result: dict, gen, prompt: list, routes,
                   tol: float) -> None:
    """Every MoE layer's experts streamed from the host (offload_moe_weights)
    in a Generator beside the resident one on the same parameters, both
    with KT_W4A8=0 (int4_g through row 10): an 8-token prompt (the gather
    path on both) and 8 greedy tokens, logits bit-identical at every step;
    then the 256 tokens of ``prompt`` as one chunk (the streamed side
    gathers each layer's distinct routed experts; the resident side takes
    the grouped path) under ``routes`` forced on both sides, held by
    hold_rows to ``tol``; bytes streamed a token and in the chunk, the
    staging's pinned bytes, and host-to-card rates: a pinned copy of one
    layer's gathered experts (CUDA events) and the gather plus copy
    (device_qtensor) on the host's clock."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.offload import experts as offload_experts
    from ktransformers_tpu_torch.offload import offload_moe_weights
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )

    spec = gen.spec
    layers = [dict(lp, moe=dict(lp["moe"], experts=offload_moe_weights(
        lp["moe"]["experts"]))) if "moe" in lp else lp
        for lp in gen.params["layers"]]
    offs = [lp["moe"]["experts"] for lp in layers if "moe" in lp]
    streamed = Generator(dict(gen.params, layers=layers), spec,
                         max_len=gen.max_len, device="cuda")
    toks = torch.tensor([prompt[:8]], device="cuda")
    same, n_tok = [], 8
    c_r, c_s = gen.new_cache(), streamed.new_cache()
    last_r, c_r = gen.prefill(c_r, toks)
    last_s, c_s = streamed.prefill(c_s, toks)
    same.append(torch.equal(last_r, last_s))
    for off in offs:
        off.bytes_streamed = 0
    # the streamed model's launches alone (counted around its steps)
    launches = {k: 0 for k in LAUNCHES}
    routed_n = {k: 0 for k in ROUTED_LAUNCHES}
    wall = 0.0
    for _ in range(n_tok):
        tok = last_r.argmax(-1)
        lr, c_r = gen._forward(tok[:, None], c_r)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ls, c_s = streamed._forward(tok[:, None], c_s)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for mine, counts in ((launches, LAUNCHES), (routed_n,
                                                    ROUTED_LAUNCHES)):
            for k, v in counts.items():
                mine[k] += v
        last_r, last_s = lr[:, -1], ls[:, -1]
        same.append(torch.equal(last_r, last_s))
    per_tok = sum(off.bytes_streamed for off in offs) / n_tok
    del c_r, c_s
    # a whole prefill chunk, under the same routes on both sides
    for off in offs:
        off.bytes_streamed = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunk_s, _ = model_steps(streamed, prompt, [], forced=routes)
    torch.cuda.synchronize()
    chunk_wall = time.perf_counter() - t0
    chunk_peak = torch.cuda.max_memory_allocated()
    chunk_bytes = sum(off.bytes_streamed for off in offs)
    chunk_r, _ = model_steps(gen, prompt, [], forced=routes)
    chunk = hold_rows(chunk_s.cpu(), chunk_r.cpu(), "streamed experts, a "
                      f"{len(prompt)}-token chunk (resident routes forced)",
                      tol)
    staging = sum(b.numel() * b.element_size()
                  for st in offload_experts._STAGING.values()
                  for b in st.bufs if b is not None)
    # the pinned copy of one layer's gathered experts alone, and the
    # host gather with it
    off, ids = offs[0], torch.arange(spec.moe.top_k)
    pinned = [torch.empty(t[: len(ids)].shape, dtype=t.dtype,
                          pin_memory=True)
              for q in (off.gate_up, off.down) for t in (q.data, q.scales)]
    nb = sum(t.numel() * t.element_size() for t in pinned)
    copy_ms = time_ms(lambda: [t.to("cuda", non_blocking=True)
                               for t in pinned], iters=10)
    gather_ms = wall_ms(lambda: [off.device_qtensor(w, ids, torch.device(
        "cuda")) for w in ("gate_up", "down")])
    rec = dict(bit_identical=same, bytes_per_token=per_tok,
               layer_bytes=nb, pinned_copy_gb_s=nb / copy_ms / 1e6,
               gather_copy_gb_s=nb / gather_ms / 1e6,
               decode_tok_s=n_tok / wall, launches=launches,
               routed_launches=routed_n,
               chunk=dict(chunk, tokens=len(prompt), bytes=chunk_bytes,
                          wall_s=chunk_wall, peak_device_bytes=chunk_peak,
                          staging_pinned_bytes=staging))
    result["offload"]["streamed"] = rec
    result["single_user_streamed"] = rec
    log(f"streamed experts: logits bit-identical to the resident model at "
        f"{sum(same)}/{len(same)} steps; {per_tok / 1e6:.1f} MB streamed a "
        f"token; a {len(prompt)}-token chunk streamed "
        f"{chunk_bytes / 1e9:.3f} GB in {chunk_wall:.2f} s, peak device "
        f"memory {chunk_peak / 1e9:.3f} GB, pinned staging "
        f"{staging / 1e9:.3f} GB; one layer's {len(ids)} experts "
        f"({nb / 1e6:.1f} MB): pinned copy {rec['pinned_copy_gb_s']:.1f} "
        f"GB/s, host gather + copy {rec['gather_copy_gb_s']:.1f} GB/s; "
        f"decode {rec['decode_tok_s']:.2f} tok/s; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    if not all(same):
        raise AssertionError(f"streamed experts leave the resident bits: "
                             f"{same}")
    if (launches["gathered_quant_matmul"]
            != 2 * (spec.num_layers - 1) * n_tok):
        raise AssertionError("streamed experts: gathered_quant_matmul "
                             f"launched {launches['gathered_quant_matmul']}")


def offload_run(result: dict) -> None:
    """Phase 21: DeepSeek-V2-Lite, 27 layers at full width, int4_g weights
    from seed 0 (phase 5's), its routed experts in host memory:
    1. one layer's HostMoELayer at 1, 8 and 256 rows against the plain
       product (host_ffn_check);
    2. full depth: the HostOffloadGenerator (bf16 hops) on requests 0 and 1
       (OFFLOAD_PROMPT + OFFLOAD_NEW tokens) at batch 2, then generate()
       with microbatches=2: the same tokens; request 2 (request 0's first
       128 tokens and 32 more) at batch 1, requests 3 and 4 (32 tokens)
       together at batch 2; the HostOffloadServeEngine on requests 0, 2, 3
       and 4 (OFFLOAD_ENGINE_NEW tokens each), held to those single-user
       tokens; launches per step held to OFFLOAD_STEP_LAUNCHES; one
       decode step profiled;
    3. request 2 with float32 hops against the resident Generator on the
       same weights with KT_W4A8=0 (bf16 activations) under the offloaded
       routes (offload_vs_resident); streamed experts bit-identical to
       that Generator at decode, and a 256-token chunk within the same
       bound (streamed_check);
    4. 2-layer parity card vs CPU (offload_parity); the host's cores, RAM
       and threads."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.offload import (
        HostOffloadGenerator,
        split_params_for_offload,
    )
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )

    cfg = bench_model_cfg()
    spec = spec_from_hf_config(cfg)
    rec = result["offload"] = dict(host=host_info(), seconds={})
    log(f"offload host: {json.dumps(rec['host'])}")
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - t_mark[0]
        t_mark[0] = now
    rng = np.random.default_rng(600)
    prompts = [rng.integers(0, spec.vocab_size, OFFLOAD_PROMPT).tolist()
               for _ in range(2)]
    prompts.append(prompts[0][:128]
                   + rng.integers(0, spec.vocab_size, 32).tolist())
    prompts += [rng.integers(0, spec.vocab_size, 32).tolist()
                for _ in range(2)]

    t0 = time.perf_counter()
    params = init_params_synthetic(spec, seed=0, quant="int4_g",
                                   device="cuda")
    dev, host = split_params_for_offload(params, spec)
    torch.cuda.synchronize()
    rec["split_s"] = time.perf_counter() - t0
    experts = params["layers"][1]["moe"]["experts"]
    rec["host_ffn"] = host_ffn_check(host[1], experts.gate_up, experts.down,
                                     spec)
    del params, experts
    gen2 = HostOffloadGenerator(dev, spec, host, max_len=512, batch=2,
                                transfer_dtype=torch.bfloat16, device="cuda")
    gen1 = HostOffloadGenerator(gen2.params, spec, host, max_len=512,
                                batch=1, transfer_dtype=torch.bfloat16,
                                device="cuda")
    del dev
    torch.cuda.empty_cache()
    rec["device_param_bytes"] = sum(t.numel() * t.element_size()
                                    for t in _leaves(gen2.params))
    rec["host_bytes"] = sum(h.nbytes for h in host.values())
    rec["threads"] = host[1].threads
    log(f"offload: split in {rec['split_s']:.1f} s; parameters on the card "
        f"{rec['device_param_bytes'] / 1e9:.3f} GB (phase 5 resident: "
        f"9.167 GB), experts on the host {rec['host_bytes'] / 1e9:.3f} GB, "
        f"host FFN on {rec['threads']} threads")
    mark("split_and_host_ffn")
    # warm-up (allocator, pinned staging, OpenMP team); not counted
    gen2.forward_chunk(torch.tensor([prompts[0][:16]] * 2, device="cuda"),
                       gen2.new_cache())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # requests 0 and 1 at batch 2 (one microbatch), then with 2
    # microbatches: the same tokens
    reset_launches()
    run = offload_greedy(gen2, prompts[:2], OFFLOAD_NEW)
    mb2 = gen2.generate(prompts[:2], max_new_tokens=OFFLOAD_NEW,
                        microbatches=2)
    result["serve_offload"] = dict(
        launches=dict(LAUNCHES), routed_launches=dict(ROUTED_LAUNCHES),
        prefill_tok_s=run["prefill_tok_s"], decode_tok_s=run["decode_tok_s"],
        tokens=run["tokens"], microbatches_2=mb2)
    log(f"offload single-user (batch 2): prefill "
        f"{run['prefill_tok_s']:.1f} tok/s, decode {run['decode_tok_s']:.2f} "
        f"tok/s; tokens with 2 microbatches equal: {mb2 == run['tokens']}")
    if mb2 != run["tokens"]:
        raise AssertionError(f"microbatches=2 {mb2} != {run['tokens']}")
    # the engine's references: request 2 at batch 1, requests 3 and 4
    # (equal lengths) together at batch 2
    one2 = offload_greedy(gen1, [prompts[2]], OFFLOAD_ENGINE_NEW)
    two = offload_greedy(gen2, prompts[3:5], OFFLOAD_ENGINE_NEW)
    result["serve_offload"]["batch1_prefill_tok_s"] = one2["prefill_tok_s"]
    result["serve_offload"]["batch1_decode_tok_s"] = one2["decode_tok_s"]
    refs = [(run["tokens"][0][:OFFLOAD_ENGINE_NEW],
             run["gaps"][0][:OFFLOAD_ENGINE_NEW]),
            (one2["tokens"][0], one2["gaps"][0])] + [
        (two["tokens"][i], two["gaps"][i]) for i in range(2)]
    got = {"prefill_chunk_b2_s256": run["chunk_launches"],
           "decode_step_b2": run["step_launches"]}
    rec["profile"] = offload_profile(gen2, run["cache"], run["last"])
    mark("single_user")
    missing = [k for k in OFFLOAD_KERNELS
               if result["serve_offload"]["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"offload single-user launched none of "
                             f"{missing}")
    offload_engine(result, gen2.params, host, spec,
                   [prompts[i] for i in (0, 2, 3, 4)], refs)
    got["serve_decode_step_b4"] = \
        result["paged_serve_offload"]["decode_step_launches"]
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["step_launches"] = got
    log(f"offload launches per step {json.dumps(got)}; peak device memory "
        f"{rec['peak_device_bytes'] / 1e9:.3f} GB")
    if got != OFFLOAD_STEP_LAUNCHES:
        raise AssertionError(f"offload launches per step {got}, want "
                             f"{OFFLOAD_STEP_LAUNCHES}")
    feed = one2["tokens"][0][:-1]
    del gen1, gen2, run, one2, two
    torch.cuda.empty_cache()
    mark("engine")

    # the resident model on the same weights with bf16 activations
    old = os.environ.get("KT_W4A8")
    os.environ["KT_W4A8"] = "0"
    try:
        params = init_params_synthetic(spec, seed=0, quant="int4_g",
                                       device="cuda")
        gen = Generator(params, spec, max_len=512, device="cuda")
        del params
        held = offload_vs_resident(gen, host, prompts[2], feed)
        rec["vs_resident"] = {k: v for k, v in held.items()
                              if k != "routes"}
        del host
        _, chunk_routes = model_steps(gen, prompts[0], [])
        streamed_check(result, gen, prompts[0], chunk_routes, held["tol"])
        del gen
    finally:
        if old is None:
            del os.environ["KT_W4A8"]
        else:
            os.environ["KT_W4A8"] = old
    torch.cuda.empty_cache()
    mark("resident_and_streamed")
    offload_parity(result)
    mark("parity")
    log(f"offload seconds: {json.dumps(rec['seconds'])}")


# ------------------------------------------------------------ speculation

SPEC_PROMPT, SPEC_NEW, SPEC_K = 512, 32, 3
# the float32 exactness run's prompt (its plain float32 expert products
# dominate its time)
SPEC_F32_PROMPT = 128
# the kernels each speculation path must launch on the 27-layer W4A8
# model: the prompt's prefill chunks (rows 1, 3, 4), the verify step's
# k + 1 rows (row 1 on w4a8_mma, row 3 on w4a8_ffn_mma, row 2's gathered
# rows on its GEMV), the one-token draft steps of the target or the draft
# model (row 5, the GEMVs); the MTP head's decode attention (row 6)
SPEC_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn", "dense_w4a8_ffn",
                "grouped_w4a8_ffn", "mla_decode_fused")
SPEC_ROUTED = ("w4a8_mma_kernel", "w4a8_gemv_kernel", "w4a8_ffn_mma_kernel",
               "w4a8_ffn_gemv_kernel", "mla_decode_split_kernel")
MTP_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn", "dense_w4a8_ffn",
               "grouped_w4a8_ffn", "mla_decode_attention")
MTP_ROUTED = ("w4a8_mma_kernel", "w4a8_ffn_mma_kernel",
              "mla_decode_split_kernel<false>")


def verify_kernel_checks(rows: list, entries: dict) -> None:
    """The verify step's shapes (k + 1 = 4 and 5 rows) at DeepSeek-V2-Lite's
    widths, against their plain versions, with bound and library times:
    row 1 on qkv_a / o_proj / lm_head / the layer-0 MLP, row 3 on the
    shared expert, row 2 on (k + 1) x 6 gathered rows."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    dev = torch.device("cuda")
    check = make_check(rows, entries)
    _, rn, w = draw(4321)
    sms = MM.sm_count(dev)
    for m in (4, 5):
        for k, n, what in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                           (2048, 102400, "lm_head"),
                           (2048, 21888, "layer-0 gate_up"),
                           (10944, 2048, "layer-0 down (gs 96)")):
            wt = w((k, n))
            dense_w4a8_check(check, rn(m, k), wt, f"verify {what} M={m}",
                             sms)
            del wt
    sgu, sdn = w((2048, 2 * 2816)), w((2816, 2048))
    for m in (4, 5):
        dense_ffn_check(check, rn(m, 2048), sgu, sdn,
                        f"verify shared I=2816 M={m}", sms)
    del sgu, sdn
    e, d, f = 64, 2048, 1408
    gu, dn = w((e, d, 2 * f)), w((e, f, d))
    per_expert = nbytes(gu.data[0], gu.scales[0], dn.data[0], dn.scales[0])
    g_cpu = torch.Generator().manual_seed(7)
    for m in (4, 5):
        r = 6 * m
        ids = torch.cat([torch.randperm(e, generator=g_cpu)[:6]
                         for _ in range(m)]).to(torch.int32).to(dev)
        used = int(torch.unique(ids).numel())
        x = rn(r, d)
        route = F.ffn_route(r, "gathered", 128, 128, f, d)
        check("gathered_w4a8_ffn", f"verify {r} rows ({m} tok x 6)", 3e-2,
              lambda: F.gathered_w4a8_ffn(x, gu, dn, ids),
              lambda: F.gathered_w4a8_ffn_ref(x, gu, dn, ids),
              lambda: F.gathered_launcher(x, gu, dn, ids),
              used * per_expert + 2 * nbytes(x), 2 * r * 3 * d * f,
              INT8_OPS_PER_S,
              up=ffn_up(x, gu, dn, ids.long(), used) if route == "gemv"
              else None,
              **routed(FFN_ROUTES, route,
                       lambda: F.gathered_launcher(x, gu, dn, ids, "silu",
                                                   "rows")))
    del gu, dn
    torch.cuda.empty_cache()


def spec_call(name: str, fn) -> dict:
    """One speculation run with the launch counts set to 0 just before and
    read just after: (tokens, stats, wall s, launches, routed)."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, stats = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=out, rounds=stats.rounds, drafted=stats.drafted,
                accepted=stats.accepted, acceptance=stats.acceptance_rate,
                wall_s=wall, out_tok_s=len(out) / wall,
                launches={k: v for k, v in LAUNCHES.items() if v},
                routed_launches={k: v for k, v in ROUTED_LAUNCHES.items()
                                 if v})


def hold_launches(what: str, rec: dict, kernels, routed_kernels) -> None:
    idle = [k for k in kernels if rec["launches"].get(k, 0) <= 0]
    idle += [k for k in routed_kernels
             if rec["routed_launches"].get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"{what}: {idle} launched no time")


def speculation_f32(result: dict) -> None:
    """On a 2-layer full-width model with float32 weights (one dense, one
    MoE layer, plain expert products), float32 compute: every speculation
    function gives Generator.generate's tokens, token for token."""
    from ktransformers_tpu_torch.engine import mtp
    from ktransformers_tpu_torch.engine.draft_spec import draft_generate
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.engine.speculative import (
        speculative_generate,
    )
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    f32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32)
    params = init_params_synthetic(spec, seed=21, quant="bf16",
                                   dtype=torch.float32, device="cuda")
    gen = Generator(params, spec, max_len=1024, device="cuda", **f32)
    # a dense-layer head (only the target's verify decides the tokens)
    head = mtp.init_mtp_synthetic(spec, seed=8, quant="bf16",
                                  dense_layer=True, device="cuda")
    prompt = np.random.default_rng(702).integers(
        0, spec.vocab_size, SPEC_F32_PROMPT).tolist()
    cfg = GenerateConfig(max_new_tokens=SPEC_NEW)
    want = gen.generate(prompt, cfg)[0]
    got = {}
    for name, fn in (
            ("speculative", lambda: speculative_generate(
                gen, gen, prompt, cfg, k=SPEC_K)),
            ("draft", lambda: draft_generate(gen, gen, prompt, cfg,
                                             k=SPEC_K)),
            ("mtp", lambda: mtp.mtp_generate(gen, head, prompt, cfg,
                                             k=SPEC_K)),
            ("mtp_single", lambda: mtp.mtp_generate_single(
                gen, head, prompt, cfg, k=SPEC_K)),
            ("mtp_fused", lambda: mtp.mtp_generate_fused(
                gen, head, prompt, cfg, k=SPEC_K))):
        out, stats = fn()
        got[name] = dict(equal=out == want, acceptance=stats.acceptance_rate)
        if out != want:
            raise AssertionError(f"speculation float32 {name}: {out} vs "
                                 f"{want}")
    result["speculation_f32"] = got
    log(f"speculation float32 (2 layers): every function's tokens equal "
        f"Generator.generate's: {json.dumps(got)}")
    del gen, params, head
    torch.cuda.empty_cache()


def speculation_run(result: dict, gen, rows: list, entries: dict) -> None:
    """Phase `speculation` on the 27-layer W4A8 DeepSeek-V2-Lite of phase 5
    (``gen``, max_len 1024): a SPEC_PROMPT-token prompt and SPEC_NEW new
    tokens at k = SPEC_K through speculative_generate (the target as its
    own draft), draft_generate (a drawn 2-layer drafter of the same widths
    and vocabulary), mtp_generate and mtp_generate_fused (an
    init_mtp_synthetic head mirroring the last, MoE, layer); each run's
    tokens held to the single-user greedy tokens by phase 6's near-tie
    rule (the verify step's float32 plain attention and w4a8_mma against
    the decode step's bf16 fused kernel and GEMVs), its rounds,
    acceptance, output tok/s (prefill included) beside the plain
    Generator's on the same host, and its launches. Then the refusal of a
    cache too short for the last round, the float32 2-layer exactness run
    and the verify shapes' kernel rows."""
    from ktransformers_tpu_torch.engine import mtp
    from ktransformers_tpu_torch.engine.draft_spec import draft_generate
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.engine.speculative import (
        speculative_generate,
    )
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    spec = gen.spec
    rec = result["speculation"] = {}
    prompt = np.random.default_rng(701).integers(
        0, spec.vocab_size, SPEC_PROMPT).tolist()
    cfg = GenerateConfig(max_new_tokens=SPEC_NEW)
    ref, gaps = single_user_reference(gen, prompt, SPEC_NEW)
    plain = spec_call("generator", lambda: (gen.generate(prompt, cfg)[0],
                                            mtp.SpecStats()))
    rec["generator"] = {k: plain[k] for k in ("wall_s", "out_tok_s")}
    log(f"speculation: plain Generator {plain['out_tok_s']:.2f} output "
        f"tok/s ({SPEC_PROMPT} + {SPEC_NEW} tokens, prefill included)")

    t0 = time.perf_counter()
    dspec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))
    draft = Generator(init_params_synthetic(dspec, seed=11, quant="int4_g",
                                            device="cuda"), dspec,
                      max_len=1024, device="cuda")
    head = mtp.init_mtp_synthetic(spec, seed=7, quant="int4_g",
                                  device="cuda")
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    runs = (("speculative", lambda: speculative_generate(
                gen, gen, prompt, cfg, k=SPEC_K), SPEC_KERNELS, SPEC_ROUTED),
            ("draft_spec", lambda: draft_generate(
                gen, draft, prompt, cfg, k=SPEC_K), SPEC_KERNELS,
             SPEC_ROUTED),
            ("mtp", lambda: mtp.mtp_generate(gen, head, prompt, cfg,
                                             k=SPEC_K), MTP_KERNELS,
             MTP_ROUTED),
            ("mtp_fused", lambda: mtp.mtp_generate_fused(
                gen, head, prompt, cfg, k=SPEC_K), MTP_KERNELS, MTP_ROUTED))
    for name, fn, kernels, routed_kernels in runs:
        r = spec_call(name, fn)
        r["first_diff"] = hold_single_user(f"speculation {name}",
                                           r["tokens"], ref, gaps)
        if r["drafted"] != r["rounds"] * SPEC_K:
            raise AssertionError(f"speculation {name}: {r['drafted']} "
                                 f"drafted in {r['rounds']} rounds")
        hold_launches(f"speculation {name}", r, kernels, routed_kernels)
        rec[name] = r
        log(f"speculation {name}: {r['rounds']} rounds, acceptance "
            f"{r['acceptance']:.3f} ({r['accepted']}/{r['drafted']}), "
            f"{r['out_tok_s']:.2f} output tok/s (plain Generator "
            f"{plain['out_tok_s']:.2f}), first difference from the "
            f"single-user tokens {r['first_diff']}; launches "
            f"{json.dumps(r['launches'])}; on the redesigned kernels "
            f"{json.dumps(r['routed_launches'])}")
    if rec["speculative"]["acceptance"] < 0.5:
        raise AssertionError("speculation: the target as its own draft "
                             f"accepted {rec['speculative']['acceptance']}")
    # a cache of prompt + max_new_tokens is refused up front
    tight = Generator(gen.params, spec, max_len=SPEC_PROMPT + SPEC_NEW,
                      device="cuda")
    try:
        speculative_generate(tight, tight, prompt, cfg, k=SPEC_K)
    except ValueError as exc:
        rec["capacity_refusal"] = str(exc)
        log(f"speculation: a cache of {SPEC_PROMPT + SPEC_NEW} positions is "
            f"refused: {exc}")
    else:
        raise AssertionError("speculation: a tight cache was not refused")
    del tight, draft, head
    torch.cuda.empty_cache()
    speculation_f32(result)
    verify_kernel_checks(rows, entries)


# ---------------------------------------------------------- sparse serve

SPARSE_FULL_LENS = (512, 384, 256, 128)
SPARSE_LONG, SPARSE_LONG_N, SPARSE_NEW = 2048, 4, 32
SPARSE_BUDGET = 8
SPARSE_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn", "dense_w4a8_ffn",
                  "grouped_w4a8_ffn", "mla_paged_prefill")
# the other anchors and retrievals, at 2 layers
SPARSE_KINDS = (("block_max", "layer"), ("block_mean", "qhead"),
                ("fixed", "layer"), ("dynamic", "qhead"), ("quest", "qhead"))


def sparse_engine_run(params, spec, prompts, new: int, sched, budget=None,
                      anchor="quest", retrieval="layer", engine_cls=None,
                      **kw) -> dict:
    """The prompts through one ServeEngine (or ``engine_cls``) at once,
    launches counted over the run: tokens, output tok/s, mean TBT, the
    engine."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.serving import ServeEngine

    eng = (engine_cls or ServeEngine)(
        params, spec, sched, num_pages=kw.pop("num_pages", 512),
        sparse_budget=budget, sparse_anchor=anchor,
        sparse_retrieval=retrieval, device="cuda", **kw)
    eng.generate_sync(prompts[-1][:16], max_new_tokens=2)  # warm-up
    eng.reset_metrics()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    qs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    tables = {}  # a query's pages and length at its last decode step
    while any(q.state != "done" for q in qs):
        if not eng.step():
            time.sleep(0.0005)
        for q in qs:
            if q.state == "decode":
                tables[q.id] = (list(q.pages), q.total_len - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tbts = [q.tbt for q in qs if q.tbt is not None]
    return dict(tokens=[list(q.output_ids) for q in qs], wall_s=wall,
                tables=[tables[q.id] for q in qs if q.id in tables],
                out_tok_s=len(qs) * new / wall,
                mean_tbt_ms=1e3 * sum(tbts) / max(len(tbts), 1),
                launches={k: v for k, v in LAUNCHES.items() if v},
                routed_launches={k: v for k, v in ROUTED_LAUNCHES.items()
                                 if v},
                engine=eng)


def plant_dead_nan(kv, tables, lengths) -> None:
    """NaN into every row of the pools a query's length does not reach:
    the rows past each length in its last page and every page no table
    names (not page 0, the trash page)."""
    named = set()
    for pt, ln in zip(tables.tolist(), lengths.tolist()):
        pages = -(-ln // kv.page_size)
        named.update(pt[:pages])
        last, used = pt[pages - 1], ln - (pages - 1) * kv.page_size
        for li in kv.paged_layers:
            kv.bufs_a[li][last, used:] = float("nan")
            kv.bufs_b[li][last, used:] = float("nan")
    dead = [p for p in range(1, kv.num_pages) if p not in named]
    for li in kv.paged_layers:
        kv.bufs_a[li][dead] = float("nan")
        kv.bufs_b[li][dead] = float("nan")


def sparse_decode_check(result: dict, run: dict, spec) -> None:
    """The card's plain sparse MLA decode against the same function on the
    CPU, on the long run's pools of one layer with NaN planted in every
    dead row: finite, within 1e-4 of the CPU's, the same pages selected;
    its time beside the paged decode kernel's (row 12) on the same pool."""
    from ktransformers_tpu_torch.ops import sparse_attention as SA
    from ktransformers_tpu_torch.ops.cuda.paged_attention import (
        mla_paged_decode,
    )

    eng = run["engine"]
    kv = eng.kv
    pmax = eng.cfg.max_pages_per_query
    tables = torch.tensor(np.stack([eng._pad_table(p)
                                    for p, _ in run["tables"]]),
                          dtype=torch.int32, device="cuda")
    lengths = torch.tensor([ln for _, ln in run["tables"]],
                           dtype=torch.int32, device="cuda")
    plant_dead_nan(kv, tables.cpu(), lengths.cpu())
    li = spec.num_layers // 2
    a = spec.attention
    g = torch.Generator(device="cuda").manual_seed(5)
    b = tables.shape[0]
    qa = torch.randn(b, a.num_heads, a.kv_lora_rank, device="cuda",
                     generator=g).bfloat16()
    qp = torch.randn(b, a.num_heads, a.qk_rope_head_dim, device="cuda",
                     generator=g).bfloat16()
    planes = kv.planes(li)
    scale = (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
    args = (kv.bufs_a[li], kv.bufs_b[li], None, None, tables, lengths,
            kv.page_size, SPARSE_BUDGET, scale, "quest", "layer", planes)
    card = SA.sparse_mla_decode(qa, qp, *args)
    cpu_args = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                     for t in args[:-1]) + (
        {k: v.cpu() for k, v in planes.items()},)
    cpu = SA.sparse_mla_decode(qa.cpu(), qp.cpu(), *cpu_args)
    sel = SA.select_pages(torch.cat([qa, qp], -1), planes, tables, lengths,
                          kv.page_size, SPARSE_BUDGET)
    sel_cpu = SA.select_pages(torch.cat([qa, qp], -1).cpu(), cpu_args[-1],
                              tables.cpu(), lengths.cpu(), kv.page_size,
                              SPARSE_BUDGET)
    same = [sorted(x) for x in sel.cpu().tolist()] == [
        sorted(x) for x in sel_cpu.tolist()]
    mae, rel = rel_err(card.cpu(), cpu)
    finite = bool(torch.isfinite(card).all())
    sparse_ms = time_ms(lambda: SA.sparse_mla_decode(qa, qp, *args),
                        iters=10)
    kernel_ms = time_ms(lambda: mla_paged_decode(
        qa, qp, kv.bufs_a[li], kv.bufs_b[li], tables, lengths, scale),
        iters=10)
    rec = dict(rel_err=rel, max_abs_err=mae, finite=finite,
               same_pages=same, sparse_ms=sparse_ms,
               paged_decode_kernel_ms=kernel_ms, batch=b,
               lengths=lengths.tolist(), budget=SPARSE_BUDGET, pmax=pmax)
    result["sparse_serve"]["decode_check"] = rec
    log(f"sparse decode card vs CPU (layer {li}, NaN in every dead row): "
        f"{json.dumps(rec)}")
    if not (finite and same and rel <= 1e-4):
        raise AssertionError(f"sparse decode card vs CPU: {rec}")


def sparse_serve_run(result: dict, gen) -> None:
    """Phase `sparse_serve` on phase 5's 27-layer W4A8 DeepSeek-V2-Lite:
    1. the ServeEngine with a budget of the whole page table (quest /
       layer) and without, on SPARSE_FULL_LENS prompts + 16 tokens: each
       held to the single-user tokens by phase 6's near-tie rule, the
       sparse run launching no paged decode kernel;
    2. SPARSE_LONG_N prompts of SPARSE_LONG tokens + SPARSE_NEW at a budget
       of SPARSE_BUDGET pages (quest / layer) against the dense engine:
       output tok/s and mean TBT of both; the card's sparse decode held to
       the CPU's on the sparse run's pools with NaN in the dead rows;
    3. at 2 layers of the same widths: the other anchors and retrievals at
       a full budget held to the single-user tokens, each also at a budget
       of 2 pages; the HostOffloadServeEngine with a full budget against
       the offloaded dense engine."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.serving import SchedulerConfig

    spec = gen.spec
    rec = result["sparse_serve"] = {}
    rng = np.random.default_rng(801)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n in SPARSE_FULL_LENS]
    refs = [single_user_reference(gen, p, 16) for p in prompts]
    sched = SchedulerConfig(max_batch_size=8, page_size=64,
                            max_pages_per_query=16)
    full = {}
    for name, budget in (("dense", None), ("sparse", 16)):
        r = sparse_engine_run(gen.params, spec, prompts, 16, sched, budget)
        r["first_diff"] = [
            hold_single_user(f"sparse_serve full budget {name} request {i}",
                             t, ref, gaps)
            for i, (t, (ref, gaps)) in enumerate(zip(r["tokens"], refs))]
        full[name] = r
    if full["sparse"]["launches"].get("mla_paged_decode", 0):
        raise AssertionError("sparse_serve: the sparse engine launched the "
                             "paged decode kernel")
    hold_launches("sparse_serve full budget", full["sparse"], SPARSE_KERNELS,
                  ())
    rec["full_budget"] = {k: {kk: v[kk] for kk in (
        "first_diff", "out_tok_s", "mean_tbt_ms", "launches")}
        for k, v in full.items()}
    log(f"sparse_serve full budget: first differences from the single-user "
        f"tokens dense {full['dense']['first_diff']}, sparse "
        f"{full['sparse']['first_diff']}; sparse launches "
        f"{json.dumps(full['sparse']['launches'])}")
    for r in full.values():
        r.pop("engine").kv = None
    del full
    torch.cuda.empty_cache()

    long_prompts = [rng.integers(0, spec.vocab_size, SPARSE_LONG).tolist()
                    for _ in range(SPARSE_LONG_N)]
    sched = SchedulerConfig(max_batch_size=SPARSE_LONG_N, page_size=64,
                            max_pages_per_query=40)
    # the published max_position_embeddings (163,840; the preset's 2,048
    # rope positions end inside these prompts), the same weights
    long_spec = spec_from_hf_config(dict(bench_model_cfg(),
                                         max_position_embeddings=163840))
    long = {}
    for name, budget in (("dense", None), ("sparse", SPARSE_BUDGET)):
        long[name] = sparse_engine_run(gen.params, long_spec, long_prompts,
                                       SPARSE_NEW, sched, budget,
                                       num_pages=256)
    agree = [sum(a == b for a, b in zip(x, y)) for x, y in zip(
        long["dense"]["tokens"], long["sparse"]["tokens"])]
    rec["partial_budget"] = dict(
        prompt=SPARSE_LONG, requests=SPARSE_LONG_N, new=SPARSE_NEW,
        budget=SPARSE_BUDGET, pages_a_prompt=SPARSE_LONG // 64,
        tokens_equal_dense=agree,
        **{f"{k}_{m}": long[k][m] for k in long
           for m in ("out_tok_s", "mean_tbt_ms", "wall_s")},
        sparse_launches=long["sparse"]["launches"])
    log(f"sparse_serve partial budget ({SPARSE_BUDGET} of "
        f"{SPARSE_LONG // 64} pages, {SPARSE_LONG_N} x {SPARSE_LONG} + "
        f"{SPARSE_NEW}): sparse {long['sparse']['out_tok_s']:.2f} output "
        f"tok/s, mean TBT {long['sparse']['mean_tbt_ms']:.1f} ms; dense "
        f"{long['dense']['out_tok_s']:.2f} tok/s, "
        f"{long['dense']['mean_tbt_ms']:.1f} ms; tokens equal to dense's "
        f"{agree} of {SPARSE_NEW}")
    if long["sparse"]["launches"].get("mla_paged_decode", 0):
        raise AssertionError("sparse_serve: partial budget launched the "
                             "paged decode kernel")
    for r in long["sparse"]["tokens"]:
        if len(r) != SPARSE_NEW or not all(0 <= t < spec.vocab_size
                                           for t in r):
            raise AssertionError(f"sparse_serve: bad tokens {r}")
    # the launches of the main sparse path (kernels line): the full-budget
    # and the partial-budget runs' sum
    result["sparse_serve_path"] = dict(
        launches=long["sparse"]["launches"],
        routed_launches=long["sparse"]["routed_launches"])
    sparse_decode_check(result, long["sparse"], spec)
    for r in long.values():
        r.pop("engine").kv = None
    del long
    torch.cuda.empty_cache()
    sparse_two_layers(result, rec)


def sparse_two_layers(result: dict, rec: dict) -> None:
    """Step 3 of sparse_serve_run at 2 layers (one dense, one MoE) of
    DeepSeek-V2-Lite's widths, int4_g weights."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.offload import (
        HostOffloadServeEngine,
        split_params_for_offload,
    )
    from ktransformers_tpu_torch.serving import SchedulerConfig

    spec = spec_from_hf_config(dict(bench_model_cfg(), num_hidden_layers=2))

    def drawn():
        return init_params_synthetic(spec, seed=31, quant="int4_g",
                                     device="cuda")

    # the offloaded engines' tree split before any repack, the resident
    # one on its own copy of the same weights
    dev_params, host = split_params_for_offload(drawn(), spec)
    gen = Generator(drawn(), spec, max_len=1024, device="cuda")
    rng = np.random.default_rng(802)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n in SPARSE_FULL_LENS]
    refs = [single_user_reference(gen, p, 16) for p in prompts]
    sched = SchedulerConfig(max_batch_size=8, page_size=64,
                            max_pages_per_query=16)
    kinds = {}
    for anchor, retrieval in SPARSE_KINDS:
        for budget in (16, 2):
            r = sparse_engine_run(gen.params, spec, prompts, 16, sched,
                                  budget, anchor, retrieval)
            key = f"{anchor}/{retrieval}/{budget}"
            if budget == 16:
                r["first_diff"] = [hold_single_user(
                    f"sparse_serve 2 layers {key} request {i}", t, ref,
                    gaps) for i, (t, (ref, gaps)) in enumerate(
                        zip(r["tokens"], refs))]
            elif r["launches"].get("mla_paged_decode", 0):
                raise AssertionError(f"sparse_serve {key}: paged decode")
            kinds[key] = {k: r.get(k) for k in ("first_diff", "out_tok_s")}
            r.pop("engine").kv = None
    rec["two_layer_kinds"] = kinds
    log(f"sparse_serve 2 layers, other anchors / retrievals: "
        f"{json.dumps(kinds)}")
    off = {}
    for name, budget in (("dense", None), ("sparse", 16)):
        r = sparse_engine_run(
            dev_params, spec, prompts, 16, sched, budget,
            engine_cls=lambda p, s, c, **kw: HostOffloadServeEngine(
                p, s, c, host_layers=host, **kw))
        off[name] = r
    diffs = [near_tie_hold(f"sparse_serve offload x sparse request {i}", s,
                           d, gaps)
             for i, (s, d, (_, gaps)) in enumerate(zip(
                 off["sparse"]["tokens"], off["dense"]["tokens"], refs))]
    if off["sparse"]["launches"].get("mla_paged_decode", 0):
        raise AssertionError("sparse_serve offload: paged decode kernel")
    rec["offload"] = dict(first_diff_from_dense=diffs, **{
        f"{k}_out_tok_s": v["out_tok_s"] for k, v in off.items()})
    result["sparse_offload_path"] = dict(
        launches=off["sparse"]["launches"],
        routed_launches=off["sparse"]["routed_launches"])
    log(f"sparse_serve offload x sparse (2 layers, full budget): first "
        f"difference from the offloaded dense engine {diffs}; "
        f"{json.dumps(rec['offload'])}")
    for r in off.values():
        r.pop("engine").kv = None
    del gen, dev_params, host, off
    torch.cuda.empty_cache()



# ---------------------------------------------------------------- parallel

PARALLEL_LAYERS = 4  # DeepSeek-V2-Lite's width, its dense layer + 3 MoE
PARALLEL_PROMPT = 256
PARALLEL_NEW = 16
PARALLEL_DECODE = 4  # decode rows of the rank checks after the prompt
PARALLEL_RANKS = 2  # ranks on the one card (gloo)
PARALLEL_JOIN_S = 420  # a rank still running then has hung
PARALLEL_EP_KERNELS = ("dense_w4a8_matmul", "gathered_w4a8_ffn",
                       "grouped_w4a8_ffn", "dense_w4a8_ffn",
                       "mla_decode_fused", "mla_paged_decode",
                       "mla_paged_prefill")
PARALLEL_TP_KERNELS = ("quant_matmul", "gathered_quant_matmul",
                       "grouped_quant_matmul", "mla_decode_fused",
                       "mla_decode_split_kernel")


def parallel_cfg(layers: int = PARALLEL_LAYERS) -> dict:
    return dict(bench_model_cfg(), num_hidden_layers=layers)


def decode_step_ms(gens: dict, prompt: list, steps: int = 8) -> dict:
    """Median wall ms of a single-user decode step (synchronised) of each
    Generator of ``gens`` after the prompt's first 256 tokens, measured in
    turns (a, b, b, a: ``steps`` steps a turn) so that a drift of the
    host's clock meets both alike."""
    state, times = {}, {name: [] for name in gens}
    for name, gen in gens.items():
        cache = gen.new_cache()
        last, cache = gen.prefill(
            cache, torch.as_tensor([prompt[:256]], device=gen.device), 256)
        state[name] = (last.float().argmax(-1)[:, None], cache)
    for name in list(gens) + list(reversed(list(gens))):
        tok, cache = state[name]
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = gens[name]._forward(tok, cache)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        state[name] = (tok, cache)
    return {name: statistics.median(v) for name, v in times.items()}


def fused_shared_run(result: dict):
    """Phase parallel, part 1: the W4A8 DeepSeek-V2-Lite (full width, cut to
    PARALLEL_LAYERS) single-user, its shared experts separate and then fused
    into the routed set (ops/fuse_shared.py: 2 shared experts of 1408, 8
    gathered rows a token): greedy tokens held to the unfused run's by
    phase 6's rule, 2-row parity (float32 compute) by moe_parity's rule,
    and the launches: no dense_w4a8_ffn in the fused run. Returns the
    unfused Generator and the spec."""
    from ktransformers_tpu_torch.engine.generate import Generator
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.ops.fuse_shared import fuse_shared_experts

    t0 = time.perf_counter()
    cfg = parallel_cfg()
    spec = spec_from_hf_config(cfg)
    prompt = np.random.default_rng(400).integers(
        0, cfg["vocab_size"], PARALLEL_PROMPT).tolist()
    gen_u = Generator(init_params_synthetic(spec, seed=0, quant="int4_g",
                                            device="cuda"),
                      spec, max_len=512, device="cuda")
    reset_launches()
    ref, gaps = single_user_reference(gen_u, prompt, PARALLEL_NEW)
    torch.cuda.synchronize()
    unfused = dict(LAUNCHES)
    fused = fuse_shared_experts(init_params_synthetic(
        spec, seed=0, quant="int4_g", device="cuda"), spec)
    n_fused = [lp["moe"]["experts"].n_shared_fused
               for lp in fused["layers"] if "moe" in lp]
    if n_fused != [2] * (PARALLEL_LAYERS - 1):
        raise AssertionError(f"fused shared experts: {n_fused}")
    gen_f = Generator(fused, spec, max_len=512, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    toks, _ = single_user_reference(gen_f, prompt, PARALLEL_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, routed_n = dict(LAUNCHES), dict(ROUTED_LAUNCHES)
    diff = hold_single_user("fused shared experts (vs unfused)", toks, ref,
                            gaps)
    moe_layers = PARALLEL_LAYERS - 1
    if launches["dense_w4a8_ffn"] != 0 \
            or unfused["dense_w4a8_ffn"] != moe_layers * PARALLEL_NEW \
            or launches["gathered_w4a8_ffn"] != moe_layers * (
                PARALLEL_NEW - 1):
        raise AssertionError(
            f"fused shared experts: dense_w4a8_ffn {launches['dense_w4a8_ffn']}"
            f" (unfused {unfused['dense_w4a8_ffn']}), gathered_w4a8_ffn "
            f"{launches['gathered_w4a8_ffn']}")
    rows_f, picks_f = routes_of(lambda: parity_rows(gen_f.params, spec,
                                                    "cuda", 64))
    rows_u, picks_u = routes_of(lambda: parity_rows(gen_u.params, spec,
                                                    "cuda", 64))
    held = hold_routed("parity fused shared vs unfused (card)", rows_f,
                       picks_f, rows_u, picks_u)
    step_ms = decode_step_ms({"fused": gen_f, "unfused": gen_u}, prompt)
    steps = {}
    for name, gen in (("fused", gen_f), ("unfused", gen_u)):
        cache = gen.new_cache()
        last, cache = gen.prefill(
            cache, torch.as_tensor([prompt], device=gen.device), 256)
        tok = last.float().argmax(-1)[:, None]
        gen._forward(tok, cache)
        before = dict(LAUNCHES)
        step_wall = wall_ms(lambda: gen._forward(tok, cache))
        steps[f"{name}_shared_decode_step"] = (
            step_wall, launch_diff(before, LAUNCHES),
            kernel_rows(lambda: gen._forward(tok, cache)))
    profile = summarize_steps(steps)
    result["parallel_fused_shared"] = dict(
        launches=launches, routed_launches=routed_n,
        unfused_launches=unfused, n_shared_fused=n_fused, first_diff=diff,
        tokens=toks[:8], wall_s=wall, decode_step_ms=step_ms, parity=held,
        profile=profile, seconds=time.perf_counter() - t0)
    log(f"parallel fused shared: {PARALLEL_LAYERS} layers, tokens equal up "
        f"to {diff}, dense_w4a8_ffn {unfused['dense_w4a8_ffn']} -> 0, "
        f"gathered_w4a8_ffn {unfused['gathered_w4a8_ffn']} -> "
        f"{launches['gathered_w4a8_ffn']}, decode step ms {step_ms}")
    del gen_f, fused
    torch.cuda.empty_cache()
    return gen_u, spec


def rebalance_serve(result: dict, gen, spec) -> None:
    """Phase parallel, part 2: a ServeEngine with collect_routing serves 4
    requests, apply_expert_rebalance(ep_size=2) re-places every MoE layer's
    experts from the counted routing, and the same requests again: both
    waves held to the single-user tokens by phase 6's rule, and the second
    wave's tokens equal to the first's (the same rows go through the same
    experts, and each token's k products are summed in route order, so a
    re-placement changes no bit); the second wave's launches are the
    path's."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

    t0 = time.perf_counter()
    vocab = spec.vocab_size
    prompts = [np.random.default_rng(500 + i).integers(0, vocab, n).tolist()
               for i, n in enumerate((256, 192, 128, 64))]
    refs = [single_user_reference(gen, p, PARALLEL_NEW) for p in prompts]
    eng = ServeEngine(gen.params, spec, SchedulerConfig(
        max_batch_size=4, max_pages_per_query=8), num_pages=64,
        enable_prefix_cache=False, collect_routing=True, device="cuda")

    def wave(tag):
        qs = [eng.submit(p, max_new_tokens=PARALLEL_NEW) for p in prompts]
        steps = 0
        while any(q.state != "done" for q in qs):
            eng.step()
            steps += 1
            if steps > 500:
                raise AssertionError(f"rebalance {tag} did not finish")
        outs = [list(q.output_ids) for q in qs]
        for i, (got, (ref, gaps)) in enumerate(zip(outs, refs)):
            hold_single_user(f"rebalance {tag} request {i}", got, ref, gaps)
        return outs

    before = wave("before")
    counted = int(eng.stats.counts.sum())
    eng.apply_expert_rebalance(ep_size=2)
    moved = sum(
        1 for lp in eng.params["layers"] if "moe" in lp and not torch.equal(
            lp["moe"]["experts"].logical_to_physical.cpu(),
            torch.arange(spec.moe.num_experts, dtype=torch.int32)))
    if counted <= 0 or moved == 0:
        raise AssertionError(f"rebalance: {counted} routed ids counted, "
                             f"{moved} layers re-placed")
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    after = wave("after")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if before != after:
        raise AssertionError(f"rebalance: tokens before {before} and after "
                             f"{after} the re-placement differ")
    result["parallel_rebalance"] = dict(
        launches=dict(LAUNCHES), routed_launches=dict(ROUTED_LAUNCHES),
        counted=counted, moved_layers=moved, wall_s=wall,
        seconds=time.perf_counter() - t0)
    log(f"parallel rebalance: {counted} routed ids counted over "
        f"{eng.stats.counts.shape[0]} layers, {moved} layers re-placed for "
        f"ep 2, the 4 requests' tokens equal after; second wave "
        f"{wall:.2f} s")
    del eng
    torch.cuda.empty_cache()


def rank_rows(params, spec, prompt, paged: bool = False,
              dtype=torch.bfloat16):
    """Logits rows [1 + PARALLEL_DECODE, V] (float32, CPU) and the decode
    steps' wall ms of a run on the card in ``dtype`` (compute and cache):
    the last position of the prompt (one chunk), then PARALLEL_DECODE steps
    on fixed tokens; through forward(), or forward_paged() over a 64-token
    page pool."""
    from ktransformers_tpu_torch.cache.paged import PagedKVCache
    from ktransformers_tpu_torch.models.model import KVCache, forward
    from ktransformers_tpu_torch.models.paged import forward_paged

    n = len(prompt)
    feed = [t % spec.vocab_size
            for t in (11, 2222, 33333, 44444, 555)[:PARALLEL_DECODE]]
    toks = torch.tensor([prompt], device="cuda")
    times = []
    if paged:
        kv = PagedKVCache.create(spec, 16, 64, dtype=dtype, device="cuda")
        table = torch.arange(1, 9, dtype=torch.int32, device="cuda")[None]

        def step(t, pos):
            return forward_paged(params, spec, t, kv, table, torch.tensor(
                [pos], dtype=torch.int32, device="cuda"),
                compute_dtype=dtype)[0]
    else:
        cache = KVCache.create(spec, 1, 512, dtype=dtype, device="cuda")

        def step(t, pos):
            return forward(params, spec, t, cache, compute_dtype=dtype,
                           logits_last_only=True)[0]
    outs = [step(toks, 0)[:, -1].float().cpu()]
    for i, tok in enumerate(feed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(torch.tensor([[tok]], device="cuda"), n + i)
        outs.append(logits[:, -1].float().cpu())
        times.append((time.perf_counter() - t0) * 1e3)
    return torch.cat(outs), times


def forcing_routes(fn, forced=None):
    """(fn(), routes): fn run with every router call of models/model.py
    recorded as its [T, k] experts. With ``forced`` (the routes of another
    run) each call takes the forced call's experts instead, weighted by
    its own scores (forced_weights), so that the two runs differ by
    rounding alone."""
    from ktransformers_tpu_torch.models import model

    route, feed, routes = model.route, iter(forced or ()), []

    def hooked(lg, cfg, bias=None):
        if forced is None:
            idx, w = route(lg, cfg, bias)
        else:
            idx = next(feed)
            w = forced_weights(lg, cfg, idx)
        routes.append(idx)
        return idx, w

    model.route = hooked
    try:
        out = fn()
    finally:
        model.route = route
    if forced is not None and len(routes) != len(forced):
        raise AssertionError(f"{len(routes)} router calls under "
                             f"{len(forced)} forced routes")
    return out, routes


def rank_check(what, mesh, params, spec, prompt, impl="psum",
               paged: bool = False, forced: bool = False) -> dict:
    """One path on this rank: the single-device run of the full params
    first (not counted), then this rank's cut under parallel_context(mesh)
    with the launch counts set to 0 just before and read just after; rows
    held to the single device's by moe_parity's rule (the all-reduce adds
    in another order, so a route can flip near a tie). With ``forced``
    (weights with no activation codes) the cut runs once more under the
    single device's routes, and every row is held to SPREAD_FACTOR times
    the rounding spread: the largest row error of the single device in
    float32 compute under the same routes."""
    from ktransformers_tpu_torch.ops.cuda import (
        LAUNCHES,
        ROUTED_LAUNCHES,
        reset_launches,
    )
    from ktransformers_tpu_torch.parallel.context import parallel_context
    from ktransformers_tpu_torch.parallel.shardings import (
        rank_spec,
        shard_params,
    )

    (ref, ref_times), ref_picks = routes_of(lambda: rank_rows(
        params, spec, prompt, paged))
    local = shard_params(params, spec, mesh)
    lspec = rank_spec(spec, mesh)
    torch.cuda.synchronize()
    mesh.collectives.clear()
    reset_launches()
    with parallel_context(mesh, ep_impl=impl):
        (rows, times), picks = routes_of(lambda: rank_rows(
            local, lspec, prompt, paged))
    torch.cuda.synchronize()
    launches, routed_n = dict(LAUNCHES), dict(ROUTED_LAUNCHES)
    held = hold_routed(what, rows, picks, ref, ref_picks)
    if forced:
        (ref, _), routes = forcing_routes(lambda: rank_rows(
            params, spec, prompt, paged))
        (f32, _), _ = forcing_routes(lambda: rank_rows(
            params, spec, prompt, paged, dtype=torch.float32), routes)
        spread = float(((f32 - ref).abs().amax(-1)
                        / ref.abs().amax(-1)).max())
        with parallel_context(mesh, ep_impl=impl):
            (rows, _), _ = forcing_routes(lambda: rank_rows(
                local, lspec, prompt, paged), routes)
        held["forced"] = dict(hold_rows(
            rows, ref, f"{what} (one device's routes forced)",
            SPREAD_FACTOR * spread), spread=spread)
    return dict(launches=launches, routed_launches=routed_n, held=held,
                decode_step_ms=statistics.median(times),
                one_device_step_ms=statistics.median(ref_times),
                collectives={"/".join(k): v
                             for k, v in mesh.collectives.items()})


# the training half: PP = 2 on Mixtral-8x7B at full width (2 layers a
# stage), ZeRO-1 at dp = 2 and EP = 2 attention-LoRA steps on
# DeepSeek-V2-Lite at full width cut to PARALLEL_LAYERS
PP_LAYERS = 4
PP_MICROBATCHES = 4  # of 1 x PP_TOKENS tokens
PP_TOKENS = 128
SFT_RANK_TOKENS = 128  # tokens a sequence of the ZeRO-1 and EP steps
LORA_B_SCALE = 0.01  # drawn b factors: every factor's gradient nonzero
ATTN_TARGETS = (r".*\.attn\.(q_proj|q_a|q_b|kv_a|o_proj|k_proj|v_proj)",)
PP_KERNELS = ("w4a8_prep", "dense_w4a8_matmul", "grouped_w4a8_matmul",
              "w4a8_mma_kernel")
# int8 weights, float32 compute: row 9's float32 route and row 11 forward,
# rows 16 and 17 (quant_wgmma_t_kernel) for every dx
PARALLEL_SFT_KERNELS = ("quant_matmul", "grouped_quant_matmul",
                        "quant_matmul_t", "grouped_quant_matmul_t",
                        "quant_wgmma_t_kernel")


def lora_drawn(params, spec, seed: int, targets=None):
    """params with rank-8 adapters (init_lora, default targets or
    ``targets``) whose b factors are drawn on the card (LORA_B_SCALE
    normals, not zero), so that every factor's gradient is nonzero."""
    from ktransformers_tpu_torch.sft.lora import (
        LoRAConfig,
        init_lora,
        tree_map_with_path,
    )

    cfg = LoRAConfig(rank=8) if targets is None else LoRAConfig(
        rank=8, target_modules=targets)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(path, t):
        if t is not None and path[-1] in ("b", "gate_up_b", "down_b"):
            return torch.randn(t.shape, generator=gen, device=t.device,
                               dtype=t.dtype) * LORA_B_SCALE
        return t

    return tree_map_with_path(draw, init_lora(params, spec, cfg, seed=seed))


def sft_batch(rows: int, tokens: int, vocab: int, seed: int):
    """(ids, labels) [rows, tokens]: seeded ids, labels = ids with the first
    32, 0, 64 and 16 labels of rows 0-3 masked (and so on in turn): the
    ranks' rows hold unequal numbers of scored labels."""
    from ktransformers_tpu_torch.sft.train import IGNORE_INDEX

    ids = np.random.default_rng(seed).integers(0, vocab, (rows, tokens))
    lengths = np.array([32, 0, 64, 16])[np.arange(rows) % 4]
    masked = np.arange(tokens)[None] < lengths[:, None]
    return ids, np.where(masked, IGNORE_INDEX, ids)


def hold_sft(what: str, loss: float, ref_loss: float, grads, ref_grads,
             names) -> dict:
    """sft_parity's rule against one device: the loss within
    SFT_LOSS_TOL, every LoRA gradient within SFT_GRAD_TOL of its norm, all
    finite and every reference gradient nonzero."""
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    errs = {n: float((g.float() - r.float()).norm()
                     / r.float().norm().clamp_min(1e-30))
            for n, g, r in zip(names, grads, ref_grads)}
    zero = [n for n, r in zip(names, ref_grads) if not r.abs().max() > 0]
    finite = np.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                       for g in grads)
    worst = max(errs.values())
    log(f"{what}: loss {loss:.6f} vs one device {ref_loss:.6f} (rel "
        f"{loss_err:.2e}), worst LoRA gradient rel {worst:.2e} over "
        f"{len(names)} leaves")
    if not finite or zero or loss_err > SFT_LOSS_TOL \
            or worst > SFT_GRAD_TOL:
        raise AssertionError(f"{what} failed: loss {loss_err}, gradients "
                             f"{errs}, zero references {zero}")
    return dict(loss=loss, loss_one_device=ref_loss, loss_rel_err=loss_err,
                worst_grad_rel_err=worst, leaves=len(names))


def counted(fn):
    """(fn(), launches, routed launches, wall s) with the launch counts read
    just before and just after fn, the card synchronised around it."""
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES

    torch.cuda.synchronize()
    before, routed = dict(LAUNCHES), dict(ROUTED_LAUNCHES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, launch_diff(before, LAUNCHES),
            launch_diff(routed, ROUTED_LAUNCHES), wall)


def merge_counts(*recs) -> dict:
    out = {}
    for rec in recs:
        for k, v in rec.items():
            out[k] = out.get(k, 0) + v
    return out


def hold_pipelined(what: str, got, ref, picks, ref_picks, mesh) -> dict:
    """moe_parity's rule for pipelined logits ``got`` [B, S, V] against the
    one-device forward's ``ref``: all finite, greedy tokens equal except at
    a near-tie, and a row past NEAR_TIE of its largest logit only where a
    route it sees differs. ``picks`` are this rank's router calls (a
    microbatch's layers of its stage in turn), ``ref_picks`` the one
    device's (one a layer, B * S tokens); the stages' differing routes are
    summed over pp, and a route differing at a position reaches every row
    after it in its sequence."""
    from ktransformers_tpu_torch.parallel.collectives import all_reduce

    b, s, v = got.shape
    per = len(picks) // b
    first = mesh.index("pp") * per
    differ = torch.zeros(b, s, device="cuda")
    for j in range(b):
        for li in range(per):
            mine, theirs = picks[j * per + li], ref_picks[first + li]
            differ[j] += torch.tensor(
                [float(x != y) for x, y in zip(mine, theirs[j * s:(j + 1) * s])],
                device="cuda")
    rerouted = (all_reduce(differ, mesh, "pp") > 0).cummax(dim=1).values
    rerouted = rerouted.reshape(-1).tolist()
    out = got.reshape(-1, v).float()
    want = ref.reshape(-1, v).float()
    top = want.abs().amax(dim=-1)
    errs = ((out - want).abs().amax(dim=-1) / top).tolist()
    top2 = torch.topk(want, 2, dim=-1).values
    gaps = ((top2[:, 0] - top2[:, 1]) / top).tolist()
    differ_tok = (out.argmax(-1) != want.argmax(-1)).tolist()
    wrong = [i for i, d in enumerate(differ_tok) if d and gaps[i] >= NEAR_TIE]
    wide = [i for i, e in enumerate(errs) if e > NEAR_TIE]
    loose = [i for i in wide if not rerouted[i]]
    log(f"{what}: worst row {max(errs):.2e} of its largest logit over "
        f"{len(errs)} rows, {len(wide)} past {NEAR_TIE} ({len(loose)} with "
        f"the same routes), greedy differ at {sum(differ_tok)} "
        f"(not a near-tie: {wrong}), {sum(rerouted)} rows see a differing "
        "route")
    if not bool(torch.isfinite(out).all()) or wrong or loose:
        raise AssertionError(f"{what} failed: rows {loose} leave the W4A8 "
                             f"spread with the same routes, tokens {wrong}")
    return dict(worst_rel_err=max(errs), past_near_tie=len(wide),
                greedy_differ=sum(differ_tok), rerouted_rows=sum(rerouted))


def pp_checks(rank: int, mesh) -> dict:
    """PP = 2 over the pipeline mesh: Mixtral-8x7B at full width cut to
    PP_LAYERS, PP_MICROBATCHES microbatches of 1 x PP_TOKENS tokens. W4A8
    (int4_g weights, bf16 compute): the pipelined logits held to the one
    device's forward() on the whole batch by hold_pipelined. int8 weights,
    float32 compute, rank-8 adapters on the default targets: the loss of
    the pipelined logits and this rank's stage's LoRA gradients held to
    the one device's by hold_sft. Each run's launches are counted apart
    from its one-device reference's."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.model import KVCache, forward
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.parallel.pp import pipeline_llm_forward
    from ktransformers_tpu_torch.sft.lora import (
        lora_leaves,
        merge_lora_params,
        split_lora,
    )
    from ktransformers_tpu_torch.sft.train import logits_nll
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    spec = spec_from_hf_config(dict(mixtral_cfg(),
                                    num_hidden_layers=PP_LAYERS))
    b, t = PP_MICROBATCHES, PP_TOKENS
    ids, labels = (torch.as_tensor(a, device="cuda")
                   for a in sft_batch(b, t, spec.vocab_size, 700))
    rec = {}
    params = prepare_params(init_params_synthetic(
        spec, seed=0, quant="int4_g", device="cuda"), spec)
    with torch.no_grad():
        (ref, ref_picks), _, _, ref_wall = counted(lambda: routes_of(
            lambda: forward(params, spec, ids, KVCache.create(
                spec, b, t, torch.bfloat16, "cuda"),
                compute_dtype=torch.bfloat16)[0]))
        mesh.collectives.clear()
        (got, picks), launches, routed_n, wall = counted(lambda: routes_of(
            lambda: pipeline_llm_forward(params, spec, ids, mesh,
                                         microbatches=b,
                                         compute_dtype=torch.bfloat16)))
        collectives = {"/".join(k): v for k, v in mesh.collectives.items()}
        steady = counted(lambda: pipeline_llm_forward(
            params, spec, ids, mesh, microbatches=b,
            compute_dtype=torch.bfloat16))[3]
        ref_steady = counted(lambda: forward(params, spec, ids, KVCache.create(
            spec, b, t, torch.bfloat16, "cuda"),
            compute_dtype=torch.bfloat16))[3]
    rec["forward"] = dict(
        hold_pipelined(f"rank {rank} PP=2 Mixtral W4A8 logits vs one device",
                       got, ref, picks, ref_picks, mesh),
        launches=launches, routed_launches=routed_n, wall_s=wall,
        one_device_wall_s=ref_wall, steady_wall_s=steady,
        one_device_steady_wall_s=ref_steady, collectives=collectives)
    del params, ref, got
    torch.cuda.empty_cache()

    params = prepare_params(init_params_synthetic(
        spec, seed=1, quant="int8", device="cuda"), spec)
    lora, base = split_lora(lora_drawn(params, spec, seed=2))
    del params
    per = PP_LAYERS // mesh.size("pp")
    mine = [(n, x) for n, x in lora_leaves(lora)
            if int(n.split("/")[1]) // per == mesh.index("pp")]
    names, leaves = [n for n, _ in mine], [x for _, x in mine]

    def loss_of(logits):
        total, count = logits_nll(logits, labels)
        return total / count

    def one_device():
        logits = forward(merge_lora_params(lora, base), spec, ids,
                         KVCache.create(spec, b, t, torch.float32, "cuda"),
                         compute_dtype=torch.float32)[0]
        loss = loss_of(logits)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def pipelined():
        loss = loss_of(pipeline_llm_forward(
            merge_lora_params(lora, base), spec, ids, mesh, microbatches=b,
            compute_dtype=torch.float32))
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    (ref_loss, ref_grads), _, _, ref_wall = counted(one_device)
    mesh.collectives.clear()
    (loss, grads), launches, routed_n, wall = counted(pipelined)
    collectives = {"/".join(k): v for k, v in mesh.collectives.items()}
    # the first pass of each pays one-time costs: a second one is timed
    steady, ref_steady = counted(pipelined)[3], counted(one_device)[3]
    rec["sft"] = dict(
        hold_sft(f"rank {rank} PP=2 Mixtral int8 LoRA loss and stage "
                 "gradients vs one device", loss, ref_loss, grads,
                 ref_grads, names),
        launches=launches, routed_launches=routed_n, wall_s=wall,
        one_device_wall_s=ref_wall, steady_wall_s=steady,
        one_device_steady_wall_s=ref_steady, collectives=collectives)
    del lora, base, grads, ref_grads
    torch.cuda.empty_cache()
    return rec


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (0 where both are zero)."""
    d, n = float((a - b).float().norm()), float(b.float().norm())
    return d / n if n > 0 else d


def hold_zero1_step(what: str, changes, names, cut) -> dict:
    """A ZeRO-1 step's change of each leaf against the one device's, as a
    share of the latter's norm: within ZERO1_STEP_TOL. The planted fault
    (each cut leaf's change with its two dp halves swapped, as a gather
    that took the ranks' rows in the wrong order would give) must lie
    above the bound, or the measure could not tell a wrong update from a
    right one."""
    errs = {n: _rel(z, o) for n, (z, o) in zip(names, changes)}
    swapped = {n: _rel(torch.cat([z[z.shape[0] // 2:], z[:z.shape[0] // 2]]),
                       o) for n, (z, o), c in zip(names, changes, cut) if c}
    worst, weakest = max(errs.values()), min(swapped.values())
    log(f"{what}: worst leaf change rel {worst:.3e} of the one device's "
        f"(bound {ZERO1_STEP_TOL:.0e}); dp halves swapped: least rel "
        f"{weakest:.3e} over {len(swapped)} cut leaves")
    if not worst <= ZERO1_STEP_TOL or not weakest > ZERO1_STEP_TOL:
        raise AssertionError(f"{what} failed: leaf change errors {errs}, "
                             f"swapped {swapped}")
    return dict(worst_change_rel_err=worst, swapped_change_least_rel=weakest)


def train_checks(rank: int, dp_mesh, ep_mesh) -> dict:
    """DeepSeek-V2-Lite at full width cut to PARALLEL_LAYERS, int8 weights,
    float32 compute, per-layer remat. ZeRO-1 at dp = 2: a Trainer over
    dp_mesh (rank-8 adapters on the default targets) and a one-device
    Trainer take the same 2 steps on 2 sequences of SFT_RANK_TOKENS
    (unequal masked labels) in lockstep, each step's loss and gradients
    held by hold_sft and each leaf's change by hold_zero1_step, every
    moment whose leading axis is even cut in half.
    EP = 2: one step of a Trainer over ep_mesh with attention adapters,
    ep_impl psum and a2a, held to a one-device Trainer's by hold_sft."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.models.spec import spec_from_hf_config
    from ktransformers_tpu_torch.sft import TrainConfig, Trainer
    from ktransformers_tpu_torch.sft.lora import lora_leaves
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    spec = spec_from_hf_config(parallel_cfg())
    params = prepare_params(init_params_synthetic(
        spec, seed=0, quant="int8", device="cuda"), spec)
    ids, labels = sft_batch(2, SFT_RANK_TOKENS, spec.vocab_size, 800)
    cfg = TrainConfig(seq_len=SFT_RANK_TOKENS)
    rec = {}

    pl = lora_drawn(params, spec, seed=3)
    one = Trainer(pl, spec, cfg, device="cuda")
    zero = Trainer(pl, spec, cfg, mesh=dp_mesh)
    del pl
    names = [n for n, _ in lora_leaves(zero.lora)]
    cut = [x.shape[0] % 2 == 0 and m.shape[0] * 2 == x.shape[0]
           for x, m in zip(zero.leaves, zero.mu)]
    dp_mesh.collectives.clear()
    steps, launches, routed_n, walls = [], [], [], []
    for step in range(2):
        before = [(a.detach().clone(), c.detach().clone())
                  for a, c in zip(zero.leaves, one.leaves)]
        ref_loss, ref_grads = one.loss_and_grads(ids, labels)
        with torch.no_grad():
            one._update(ref_grads)

        def zero_step():
            loss, grads = zero.loss_and_grads(ids, labels)
            with torch.no_grad():
                zero._update(grads)
            return loss, grads

        (loss, grads), n, r, wall = counted(zero_step)
        steps.append(hold_sft(f"rank {rank} ZeRO-1 dp=2 step {step} vs one "
                              "device", loss, ref_loss, grads, ref_grads,
                              names))
        steps[-1].update(hold_zero1_step(
            f"rank {rank} ZeRO-1 dp=2 step {step}",
            [(a.detach() - b[0], c.detach() - b[1]) for a, c, b in
             zip(zero.leaves, one.leaves, before)], names, cut))
        launches.append(n)
        routed_n.append(r)
        walls.append(wall)
    moments = {n: (list(m.shape), list(x.shape))
               for n, x, m in zip(names, zero.leaves, zero.mu)}
    uncut = [n for n, (m, x) in moments.items()
             if x[0] % 2 == 0 and m[0] * 2 != x[0]]
    if uncut or not any(cut):
        raise AssertionError(f"rank {rank} ZeRO-1: moments {uncut} not cut "
                             f"over dp ({moments})")
    log(f"rank {rank} ZeRO-1: {len(moments)} moments, {sum(cut)} cut in "
        f"half; step walls {walls}")
    rec["zero1"] = dict(
        steps=steps, launches=merge_counts(*launches),
        routed_launches=merge_counts(*routed_n), step_wall_s=walls,
        moments=moments,
        collectives={"/".join(k): v for k, v in dp_mesh.collectives.items()})
    del one, zero
    torch.cuda.empty_cache()

    pl = lora_drawn(params, spec, seed=4, targets=ATTN_TARGETS)
    one = Trainer(pl, spec, cfg, device="cuda")
    (ref_loss, ref_grads), _, _, ref_wall = counted(
        lambda: one.loss_and_grads(ids, labels))
    names = [n for n, _ in lora_leaves(one.lora)]
    del one
    rec["ep"] = {}
    for impl in ("psum", "a2a"):
        tr = Trainer(pl, spec, cfg, mesh=ep_mesh, ep_impl=impl)
        ep_mesh.collectives.clear()

        def ep_step():
            loss, grads = tr.loss_and_grads(ids, labels)
            with torch.no_grad():
                tr._update(grads)
            return loss, grads

        (loss, grads), n, r, wall = counted(ep_step)
        rec["ep"][impl] = dict(
            hold_sft(f"rank {rank} EP=2 ({impl}) attention LoRA step vs one "
                     "device", loss, ref_loss, grads, ref_grads, names),
            launches=n, routed_launches=r, wall_s=wall,
            one_device_wall_s=ref_wall,
            collectives={"/".join(k): v
                         for k, v in ep_mesh.collectives.items()})
        del tr
        torch.cuda.empty_cache()
    return rec


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One of the ranks that share the card (spawned by parallel_ranks):
    gloo group through a file rendezvous in ``tmp``; EP = 2 on the W4A8
    DeepSeek-V2-Lite (a2a prefill chunk and psum decode, contiguous and
    paged), then TP = 2 on its int8 weights (8 heads a rank), then the
    training half: PP = 2 on Mixtral-8x7B (pp_checks), ZeRO-1 at dp = 2
    and EP = 2 attention-LoRA steps (train_checks); its record to
    tmp/rank<r>.json, a failure's traceback to tmp/rank<r>.err."""
    import traceback

    import torch.distributed as dist

    try:
        from ktransformers_tpu_torch.models.init import init_params_synthetic
        from ktransformers_tpu_torch.models.spec import spec_from_hf_config
        from ktransformers_tpu_torch.parallel.distributed import (
            init_multihost,
        )
        from ktransformers_tpu_torch.parallel.mesh import make_mesh
        from ktransformers_tpu_torch.parallel.pp import make_pp_mesh
        from ktransformers_tpu_torch.utils.device_prep import prepare_params

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = init_multihost(dp=1, ep=world, tp=1, backend="gloo",
                              init_method=f"file://{tmp}/rendezvous",
                              world_size=world, rank=rank, device="cuda:0",
                              timeout_s=PARALLEL_JOIN_S / 2)
        rec = dict(rank=rank, world=world, backend=dist.get_backend(),
                   card=card_line())
        cfg = parallel_cfg()
        spec = spec_from_hf_config(cfg)
        prompt = np.random.default_rng(600).integers(
            0, cfg["vocab_size"], PARALLEL_PROMPT).tolist()
        params = prepare_params(init_params_synthetic(
            spec, seed=0, quant="int4_g", device="cuda"), spec)
        rec["ep"] = rank_check(f"rank {rank} EP={world} (a2a chunk, psum "
                               "decode) vs one device", mesh, params, spec,
                               prompt, impl="a2a")
        rec["ep_paged"] = rank_check(f"rank {rank} EP={world} paged vs one "
                                     "device", mesh, params, spec, prompt,
                                     impl="a2a", paged=True)
        del params
        torch.cuda.empty_cache()
        tp_mesh = make_mesh(dp=1, ep=1, tp=world, device="cuda:0")
        params = prepare_params(init_params_synthetic(
            spec, seed=0, quant="int8", device="cuda"), spec)
        rec["tp"] = rank_check(f"rank {rank} TP={world} int8 vs one device",
                               tp_mesh, params, spec, prompt, forced=True)
        del params
        torch.cuda.empty_cache()
        rec["pp"] = pp_checks(rank, make_pp_mesh(device="cuda:0"))
        rec["train"] = train_checks(
            rank, make_mesh(dp=world, ep=1, tp=1, device="cuda:0"), mesh)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_ranks(result: dict) -> None:
    """Phase parallel, parts 3 and 4: PARALLEL_RANKS processes (spawn; the
    kernels were built before) share the one card over gloo, whose CUDA
    path takes all-reduce and whose other collectives the port copies
    through the host (parallel/collectives.py): no interconnect is
    measured. A rank that fails, or runs past PARALLEL_JOIN_S, fails the
    phase."""
    import multiprocessing
    import tempfile

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kt_parallel_") as tmp:
        procs = [ctx.Process(target=parallel_rank,
                             args=(r, PARALLEL_RANKS, tmp))
                 for r in range(PARALLEL_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + PARALLEL_JOIN_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {}
        recs = []
        for r in range(PARALLEL_RANKS):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    errs[r] = fh.read()
            out = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(out):
                with open(out) as fh:
                    recs.append(json.load(fh))
    if hung or errs or len(recs) != PARALLEL_RANKS \
            or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"parallel ranks: hung {hung}, exit codes "
            f"{[p.exitcode for p in procs]}, errors {errs}")
    for rec in recs:
        ep_sft = rec["train"]["ep"]
        # the EP path: its contiguous and its paged run; the EP training
        # path: its psum and its a2a step
        rec["paths"] = {
            "ep": {k: merge_counts(rec["ep"][k], rec["ep_paged"][k])
                   for k in ("launches", "routed_launches")},
            "tp": rec["tp"], "pp": rec["pp"]["forward"],
            "pp_sft": rec["pp"]["sft"], "zero1": rec["train"]["zero1"],
            "ep_sft": {k: merge_counts(ep_sft["psum"][k], ep_sft["a2a"][k])
                       for k in ("launches", "routed_launches")}}
        for path, keys in (("ep", PARALLEL_EP_KERNELS),
                           ("tp", PARALLEL_TP_KERNELS),
                           ("pp", PP_KERNELS),
                           ("pp_sft", PARALLEL_SFT_KERNELS),
                           ("zero1", PARALLEL_SFT_KERNELS),
                           ("ep_sft", PARALLEL_SFT_KERNELS)):
            counts = {**rec["paths"][path]["launches"],
                      **rec["paths"][path]["routed_launches"]}
            missing = [k for k in keys if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"rank {rec['rank']} {path}: "
                                     f"{missing} not launched")
            launched = json.dumps({k: v for k, v in counts.items() if v})
            if path in ("ep", "tp"):
                log(f"parallel rank {rec['rank']} {path.upper()}="
                    f"{rec['world']} ({rec['backend']}; {rec['card']}): "
                    f"decode step {rec[path]['decode_step_ms']:.2f} ms (one "
                    f"device, the other rank beside it: "
                    f"{rec[path]['one_device_step_ms']:.2f}), launches "
                    f"{launched}, collectives "
                    f"{json.dumps(rec[path]['collectives'])}")
            else:
                log(f"parallel rank {rec['rank']} {path} ({rec['backend']}; "
                    f"{rec['card']}): launches {launched}")
        for name, run in (("PP=2 forward", rec["pp"]["forward"]),
                          ("PP=2 SFT", rec["pp"]["sft"]),
                          ("EP=2 psum SFT step", ep_sft["psum"]),
                          ("EP=2 a2a SFT step", ep_sft["a2a"])):
            steady = "" if "steady_wall_s" not in run else (
                f"; again {run['steady_wall_s']:.3f} s (one device "
                f"{run['one_device_steady_wall_s']:.3f})")
            log(f"parallel rank {rec['rank']} {name}: {run['wall_s']:.3f} s "
                f"(one device, the other rank beside it: "
                f"{run['one_device_wall_s']:.3f}){steady}, collectives "
                f"{json.dumps(run['collectives'])}")
        zero1 = rec["train"]["zero1"]
        log(f"parallel rank {rec['rank']} ZeRO-1 dp=2 steps "
            f"{[round(w, 3) for w in zero1['step_wall_s']]} s, collectives "
            f"{json.dumps(zero1['collectives'])}")
    result["parallel_ranks"] = dict(ranks=recs,
                                    seconds=time.perf_counter() - t0)


def parallel_run(result: dict, rows: list, entries: dict) -> None:
    """The phase ``parallel``: fused shared experts, routing statistics
    with re-placement, the MLA kernels at a TP rank's 8 heads against their
    plain versions (NaN past every length and in the memory after the
    queries), then EP and TP over ranks that share the card."""
    gen, spec = fused_shared_run(result)
    rebalance_serve(result, gen, spec)
    del gen
    torch.cuda.empty_cache()
    mla_eight_head_checks(rows, entries)
    torch.cuda.empty_cache()
    parallel_ranks(result)


def mla_eight_head_checks(rows: list, entries: dict) -> None:
    """Rows 5, 12 and 14 at 8 heads (DeepSeek-V2-Lite's 16 over tp = 2):
    mla_decode_split_kernel through mla_decode_fused at 512 cached rows,
    the queries followed in memory by 8 NaN head rows that the kernel's
    16-row tile must not take; the paged decode and prefill at the serving
    shapes (paged_kernel_checks at h = 8). Row 5's library yardstick is
    one SDPA, as at 128 heads."""
    import torch.nn.functional as tF

    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.rope import (
        RopeConfig,
        precompute_rope_tables,
        rope_rotation_matrix,
    )

    check = make_check(rows, entries)
    dev = torch.device("cuda")
    _, rn, _ = draw(21)

    def guarded(b, h, width):
        buf = torch.full((b * h + 8, width), float("nan"),
                         dtype=torch.bfloat16, device=dev)
        buf[: b * h] = rn(b * h, width)
        return buf[: b * h].view(b, h, width)

    b, h, r, dr, smax, length = 1, 8, 512, 64, 1024, 512
    cos, sin = precompute_rope_tables(RopeConfig(dim=dr, max_position=smax,
                                                 interleaved=True), dev)
    rot = rope_rotation_matrix(cos[length][None], sin[length][None], True)
    qn, qp, kv = guarded(b, h, r), guarded(b, h, dr), rn(b, 1, r + dr)
    gamma = torch.ones(r, device=dev)
    ckv, kpe = rn(b, smax, r), rn(b, smax, dr)
    ckv[:, length:] = float("nan")
    kpe[:, length:] = float("nan")
    lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
    args = (qn, qp, kv, gamma, rot, ckv, kpe, lengths, (128 + 64) ** -0.5,
            1e-6)
    # the library yardstick: one SDPA over the cache's first length + 1
    # rows (the current token's latent in the last), as row 5's V3 line
    lib_c = torch.nan_to_num(ckv[:, : length + 1])
    lib_q = torch.cat([qn, qp], dim=-1)[:, :, None]
    lib_k = torch.cat([lib_c, torch.nan_to_num(kpe[:, : length + 1])],
                      dim=-1)[:, None].expand(-1, h, -1, -1)
    lib_v = lib_c[:, None].expand(-1, h, -1, -1)
    check("mla_decode_fused", f"tp rank decode H={h} cached={length} "
          f"S={smax}", 1e-2, lambda: MD.mla_decode_fused(*args),
          lambda: MD.mla_decode_fused_ref(*args),
          lambda: MD.mla_launcher(*args),
          length * (r + dr) * 2 + nbytes(qn, qp, kv) + b * h * r * 2,
          2 * h * (length + 1) * (2 * r + dr), BF16_FLOPS_PER_S,
          library=lambda: tF.scaled_dot_product_attention(
              lib_q, lib_k, lib_v, scale=(128 + 64) ** -0.5),
          **routed(MLA_DECODE_ROUTES, MD.route(torch.bfloat16),
                   lambda: MD.mla_launcher(*args, "fused")))
    del ckv, kpe, lib_c, lib_k, lib_v
    paged_kernel_checks(check, rn, dev, h=h, prefix="tp rank ")

def _qtensors(node):
    import dataclasses

    from ktransformers_tpu_torch.quant.formats import QTensor

    if isinstance(node, QTensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _qtensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _qtensors(v)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _qtensors(getattr(node, f.name))


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
    from ktransformers_tpu_torch.ops.cuda import (
        KERNELS,
        ROUTED_KERNELS,
        _build,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every capture keeps its graph's nodes for hold_replay_kernels
    from ktransformers_tpu_torch.engine import cuda_graph

    cuda_graph.DEBUG_GRAPHS = True
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    result: dict = {}
    marks = [("start", time.perf_counter())]
    result["phase_s"] = {}

    def phase(name: str) -> None:
        """Seconds since the last mark into result["phase_s"][name]."""
        now = time.perf_counter()
        result["phase_s"][name] = now - marks[-1][1]
        marks.append((name, now))
        with open(os.path.join(OUT_DIR, "phase_s.json"), "w") as fh:
            json.dump(result["phase_s"], fh, indent=1)
        log(f"phase {name}: {result['phase_s'][name]:.1f} s "
            f"({now - marks[0][1]:.1f} s in all)")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    result["card"] = card

    t0 = time.perf_counter()
    # the two host libraries (g++) build beside the nvcc jobs
    from ktransformers_tpu_torch.loader import native
    from ktransformers_tpu_torch.offload import host_moe

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        host_libs = [pool.submit(native.build), pool.submit(host_moe.build)]
        logs = _build.build_all()
        if not host_libs[0].result():
            raise RuntimeError("g++ failed for csrc/ggml_decode.cpp")
        host_libs[1].result()
    build_s = time.perf_counter() - t0
    log(f"build: {len(logs)} sources in {build_s:.1f} s")
    result["build_s"] = build_s
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
        for name, text in logs.items():
            fh.write(f"== {name}\n{text}\n")
    phase("build")

    # a second of bf16 products first, so the card's clocks have risen
    # before the first kernel is timed
    warm = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()
    del warm

    rows: list = []
    entries: dict = {}
    result["kernel_rows"] = rows
    kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    zero_point_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    phase("kernels")

    variants = list(parity_variants())
    parity_check(result, variants)
    paged_parity_check(result, variants)
    penalty_check(result)
    del variants
    # one weight format at a time (each model is ~1 GB on the host)
    for kind in QUANT_KINDS:
        variant = [format_variant(kind)]
        parity_check(result, variant)
        if kind == "int8":
            paged_parity_check(result, variant)
        del variant
    torch.cuda.empty_cache()
    phase("parity")

    gen = serve(result, checks=True)
    paged_serve(result, gen, eager=True)
    profile_steps(result, gen)
    profile_engine_steps(result, gen)
    hold_prep(result, b8=DEEPSEEK_B8_PREPS)
    phase("serve_w4a8")

    # speculation and sparse long-context decode on the same parameters
    speculation_run(result, gen, rows, entries)
    phase("speculation")
    sparse_serve_run(result, gen)
    phase("sparse_serve")

    # the front door: the HTTP server over the same parameters, then the
    # CLI (convert, doctor, serve) on a 2-layer HF directory
    http_serve(result, gen)
    del gen
    torch.cuda.empty_cache()
    front_door_cli(result)
    phase("front_door")

    # the int8 path: every matmul through the quant_matmul kernels
    gen = serve(result, quant="int8", key="serve_int8", requests=2,
                expect=INT8_SINGLE_USER_KERNELS, unfused_last=True,
                cfg=dict(bench_model_cfg(), num_hidden_layers=INT8_LAYERS),
                checks=True)
    int8_step_launches(result, gen)
    paged_serve(result, gen, key="paged_serve_int8", depths=(3,),
                expect=INT8_PAGED_KERNELS, eager=True)
    profile_steps(result, gen, prefix="int8_")
    profile_engine_steps(result, gen, prefix="int8_")
    del gen
    torch.cuda.empty_cache()
    phase("serve_int8")

    mixtral_run(result, rows, entries)
    phase("mixtral")

    # LoRA SFT on DeepSeek-V2-Lite: rows 16 and 17 in the backward
    sft_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    sft_parity(result)
    torch.cuda.empty_cache()
    sft_run(result)
    torch.cuda.empty_cache()
    phase("sft")

    # DeepSeek-V3: its kernels at full width, 2-layer parity, then 6
    # layers served; the plain expert products at DeepSeek-V2-Lite's
    # width and the HF import between them
    v3_kernel_checks(rows, entries)
    torch.cuda.empty_cache()
    routed_parity(result, v3_variant())
    parity_check(result, [bf16_experts_variant()])
    torch.cuda.empty_cache()
    v3_serve(result)
    v3_int8_engine(result)
    phase("v3")
    # a DeepSeek-V2-Lite GGUF checkpoint (Q4_K blocks) on the W4A8 kernels
    gguf_serve(result)
    torch.cuda.empty_cache()
    phase("gguf")
    # Qwen3-30B-A3B cut to QWEN3_LAYERS, Qwen2-57B-A14B cut to 4 layers
    qwen_run(result, rows, entries)
    phase("qwen")
    # 9,000 tokens into a 16,384-position cache: blockwise against dense
    long_context(result)
    phase("long_context")
    # Llama-3.1-8B at full depth, GLM-4.5-Air cut to GLM_LAYERS
    dense_glm_run(result, rows, entries)
    phase("dense_glm")
    # SmallThinker-21B past its window, Qwen3-Next's hybrid layers
    hybrid_window_run(result, rows, entries)
    phase("hybrid_window")
    # DeepSeek-V2-Lite with its routed experts in host memory
    offload_run(result)
    torch.cuda.empty_cache()
    phase("offload")
    # fused shared experts, routing statistics and re-placement, then EP
    # and TP over ranks that share the card
    parallel_run(result, rows, entries)
    torch.cuda.empty_cache()
    phase("parallel")

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
        "mla_paged_decode": (
            "ktransformers_tpu_torch/csrc/paged_attention.cu",
            "ktransformers_tpu/ops/pallas/paged_attention.py:124"),
        "mla_paged_prefill": (
            "ktransformers_tpu_torch/csrc/paged_attention.cu",
            "ktransformers_tpu/ops/pallas/paged_attention.py:455"),
        "quant_matmul": (
            "ktransformers_tpu_torch/csrc/quant_matmul.cu",
            "ktransformers_tpu/ops/pallas/quant_matmul.py:225"),
        "gathered_quant_matmul": (
            "ktransformers_tpu_torch/csrc/quant_matmul.cu",
            "ktransformers_tpu/ops/pallas/quant_matmul.py:452"),
        "grouped_quant_matmul": (
            "ktransformers_tpu_torch/csrc/quant_matmul.cu",
            "ktransformers_tpu/ops/pallas/quant_matmul.py:655"),
        "mla_decode_attention": (
            "ktransformers_tpu_torch/csrc/mla_decode.cu",
            "ktransformers_tpu/ops/pallas/mla_decode.py:296"),
        "gathered_w4a8_matmul": (
            "ktransformers_tpu_torch/csrc/w4a8_matmul.cu",
            "ktransformers_tpu/ops/pallas/w4a8_matmul.py:133"),
        "grouped_w4a8_matmul": (
            "ktransformers_tpu_torch/csrc/w4a8_matmul.cu",
            "ktransformers_tpu/ops/pallas/w4a8_matmul.py:630"),
        "gqa_paged_decode": (
            "ktransformers_tpu_torch/csrc/gqa_paged_attention.cu",
            "ktransformers_tpu/ops/pallas/paged_attention.py:288"),
        "gqa_paged_prefill": (
            "ktransformers_tpu_torch/csrc/gqa_paged_attention.cu",
            "ktransformers_tpu/ops/pallas/paged_attention.py:632"),
        "quant_matmul_t": (
            "ktransformers_tpu_torch/csrc/quant_matmul_t.cu",
            "ktransformers_tpu/ops/pallas/quant_matmul_t.py:172"),
        "grouped_quant_matmul_t": (
            "ktransformers_tpu_torch/csrc/quant_matmul_t.cu",
            "ktransformers_tpu/ops/pallas/quant_matmul_t.py:387"),
    }
    # launches: each main path was driven with the counts set to 0 just
    # before and read just after (single-user serve and paged serve at the
    # default pipeline depth: DeepSeek-V2-Lite on the int4_g parameters,
    # the same behind the HTTP server, then on the int8 parameters, then
    # Mixtral-8x7B; then the SFT steps; then DeepSeek-V3 on
    # W4A8 and on int8 parameters; then the GGUF DeepSeek-V2-Lite; then
    # Qwen3-30B-A3B and Qwen2-57B-A14B; then Llama-3.1-8B and
    # GLM-4.5-Air; then SmallThinker-21B and Qwen3-Next-80B-A3B); a
    # kernel's count is the sum over them
    runs = {
        "single_user": result["serve"],
        "paged_serve": result["paged_serve"]["runs"][3],
        "http_serve": result["http_serve"],
        "single_user_int8": result["serve_int8"],
        "paged_serve_int8": result["paged_serve_int8"]["runs"][3],
        "single_user_mixtral": result["serve_mixtral"],
        "paged_serve_mixtral": result["paged_serve_mixtral"]["runs"][3],
        "sft": result["sft"],
        "single_user_v3": result["serve_v3"],
        "paged_serve_v3": result["paged_serve_v3"]["runs"][3],
        "single_user_v3_int8": result["serve_v3_int8"],
        "paged_serve_v3_int8": result["paged_serve_v3_int8"]["runs"][3],
        "single_user_gguf": result["serve_gguf"],
        "paged_serve_gguf": result["paged_serve_gguf"]["runs"][3],
        "single_user_qwen3": result["serve_qwen3"],
        "paged_serve_qwen3": result["paged_serve_qwen3"]["runs"][3],
        "single_user_qwen2": result["serve_qwen2"],
        "paged_serve_qwen2": result["paged_serve_qwen2"]["runs"][3],
        "single_user_llama": result["serve_llama"],
        "paged_serve_llama": result["paged_serve_llama"]["runs"][3],
        "single_user_glm": result["serve_glm"],
        "paged_serve_glm": result["paged_serve_glm"]["runs"][3],
        "single_user_smallthinker": result["serve_smallthinker"],
        "paged_serve_smallthinker":
            result["paged_serve_smallthinker"]["runs"][3],
        "single_user_qnext": result["serve_qnext"],
        "paged_serve_qnext": result["paged_serve_qnext"]["runs"][3],
        "single_user_offload": result["serve_offload"],
        "paged_serve_offload": result["paged_serve_offload"],
        "single_user_streamed": result["single_user_streamed"],
        "speculative": result["speculation"]["speculative"],
        "draft_spec": result["speculation"]["draft_spec"],
        "mtp": result["speculation"]["mtp"],
        "mtp_fused": result["speculation"]["mtp_fused"],
        "sparse_serve": result["sparse_serve_path"],
        "sparse_offload": result["sparse_offload_path"],
        "parallel_fused_shared": result["parallel_fused_shared"],
        "parallel_rebalance": result["parallel_rebalance"],
    }
    # each rank's launches of its EP run (contiguous and paged) and TP run
    for rec in result["parallel_ranks"]["ranks"]:
        for path, r in rec["paths"].items():
            runs[f"parallel_{path}_rank{rec['rank']}"] = r
    paths = {k: dict(r["launches"]) for k, r in runs.items()}
    # the redesigned kernels: launches of their wrappers' calls that took them
    for kernel in ROUTED_KERNELS:
        for k, r in runs.items():
            paths[k][kernel] = r["routed_launches"].get(kernel, 0)
    sources["quant_mma_kernel"] = (
        "ktransformers_tpu_torch/csrc/quant_matmul.cu",
        "ktransformers_tpu/ops/pallas/quant_matmul.py:225")
    sources["w4a8_mma_kernel"] = (
        "ktransformers_tpu_torch/csrc/w4a8_mma.cuh",
        "ktransformers_tpu/ops/pallas/w4a8_matmul.py:930")
    sources["quant_gemv_kernel"] = (
        "ktransformers_tpu_torch/csrc/quant_matmul.cu",
        "ktransformers_tpu/ops/pallas/quant_matmul.py:225")
    sources["quant_wgmma_t_kernel"] = (
        "ktransformers_tpu_torch/csrc/quant_matmul_t.cu",
        "ktransformers_tpu/ops/pallas/quant_matmul_t.py:172")
    sources["w4a8_gemv_kernel"] = (
        "ktransformers_tpu_torch/csrc/w4a8_gemv.cuh",
        "ktransformers_tpu/ops/pallas/w4a8_matmul.py:930")
    sources["w4a8_ffn_mma_kernel"] = (
        "ktransformers_tpu_torch/csrc/w4a8_ffn.cu",
        "ktransformers_tpu/ops/pallas/w4a8_matmul.py:818")
    sources["mla_decode_split_kernel"] = (
        "ktransformers_tpu_torch/csrc/mla_decode.cu",
        "ktransformers_tpu/ops/pallas/mla_decode.py:199")
    sources["mla_prefill_mma_kernel"] = (
        "ktransformers_tpu_torch/csrc/paged_attention.cu",
        "ktransformers_tpu/ops/pallas/paged_attention.py:455")
    sources["mla_paged_decode_split_kernel"] = (
        "ktransformers_tpu_torch/csrc/paged_attention.cu",
        "ktransformers_tpu/ops/pallas/paged_attention.py:124")
    sources["gqa_prefill_mma_kernel"] = (
        "ktransformers_tpu_torch/csrc/gqa_paged_attention.cu",
        "ktransformers_tpu/ops/pallas/paged_attention.py:632")
    sources["w4a8_ffn_gemv_kernel"] = (
        "ktransformers_tpu_torch/csrc/w4a8_ffn.cu",
        "ktransformers_tpu/ops/pallas/w4a8_matmul.py:308")
    sources["gqa_decode_split_kernel"] = (
        "ktransformers_tpu_torch/csrc/gqa_paged_attention.cu",
        "ktransformers_tpu/ops/pallas/paged_attention.py:288")
    sources["mla_decode_split_kernel<false>"] = (
        "ktransformers_tpu_torch/csrc/mla_decode.cu",
        "ktransformers_tpu/ops/pallas/mla_decode.py:296")
    for name, zp in zip(W4A8_REDESIGNED, W4A8_ZP):
        sources[zp] = sources[name]
    sources["w4a8_prep_block_kernel"] = (
        "ktransformers_tpu_torch/csrc/w4a8_core.cuh",
        "ktransformers_tpu/quant/w4a8.py:92")
    # the attention kernels carry their paths' attention: on both DeepSeek
    # parameter sets the MLA decode single-user, the paged decode and the
    # prefill in the served steps; on Mixtral the GQA decode and prefill in
    # the served steps; the FFN's one-row gate_up every W4A8 decode
    for kernel, keys in (
            ("mla_decode_split_kernel", ("single_user", "single_user_int8",
                                         "single_user_v3")),
            ("mla_prefill_mma_kernel", ("paged_serve", "paged_serve_int8",
                                        "paged_serve_v3")),
            ("mla_paged_decode_split_kernel",
             ("paged_serve", "paged_serve_int8", "paged_serve_v3")),
            ("w4a8_gemv_kernel", ("single_user_v3", "paged_serve_v3")),
            ("w4a8_mma_kernel", ("single_user_v3", "paged_serve_v3")),
            ("gqa_prefill_mma_kernel", ("paged_serve_mixtral",
                                        "paged_serve_qwen3",
                                        "paged_serve_qwen2",
                                        "paged_serve_llama",
                                        "paged_serve_glm",
                                        "paged_serve_smallthinker",
                                        "paged_serve_qnext")),
            ("gqa_decode_split_kernel", ("paged_serve_mixtral",
                                         "paged_serve_qwen3",
                                         "paged_serve_qwen2",
                                         "paged_serve_llama",
                                         "paged_serve_glm",
                                         "paged_serve_smallthinker",
                                         "paged_serve_qnext")),
            # SmallThinker's windowed layers and Qwen3-Next's D = 256 on
            # both GQA wrappers; their ReLU / silu experts on the fused FFN
            *((k, ("paged_serve_smallthinker", "paged_serve_qnext"))
              for k in ("gqa_paged_decode", "gqa_paged_prefill")),
            *((k, ("single_user_smallthinker", "paged_serve_smallthinker",
                   "single_user_qnext", "paged_serve_qnext"))
              for k in ("gathered_w4a8_ffn", "grouped_w4a8_ffn",
                        "w4a8_ffn_gemv_kernel", "w4a8_ffn_mma_kernel",
                        "quant_matmul")),
            # row 9 on Llama's paths (its GEMV at decode, its tensor-core
            # kernel at prefill), rows 13 and 15 on both models' paged
            # paths, GLM's experts on rows 7 and 8
            *((k, ("single_user_llama", "paged_serve_llama"))
              for k in ("quant_matmul", "quant_gemv_kernel",
                        "quant_mma_kernel")),
            *((k, ("paged_serve_llama", "paged_serve_glm"))
              for k in ("gqa_paged_decode", "gqa_paged_prefill")),
            *((k, ("single_user_glm", "paged_serve_glm"))
              for k in ("gathered_w4a8_matmul", "grouped_w4a8_matmul",
                        "w4a8_gemv_kernel", "w4a8_mma_kernel")),
            ("w4a8_ffn_gemv_kernel", ("single_user", "paged_serve",
                                      "single_user_qwen3",
                                      "paged_serve_qwen3")),
            ("w4a8_ffn_mma_kernel", ("single_user_qwen3",
                                     "paged_serve_qwen3")),
            ("w4a8_gemv_kernel", ("single_user_qwen2", "paged_serve_qwen2")),
            ("w4a8_mma_kernel", ("single_user_qwen2", "paged_serve_qwen2")),
            *((k, ("single_user_gguf", "paged_serve_gguf"))
              for k in W4A8_ZP),
            ("mla_decode_split_kernel<false>", ("single_user_int8",)),
            # rows 1-4, 12 and 14 behind the HTTP server
            *((k, ("http_serve",)) for k in HTTP_KERNELS),
            # the offloaded DeepSeek-V2-Lite: its shared experts on row 3,
            # its attention on rows 5 / 12 / 14; the streamed experts on
            # row 10's GEMV
            *((k, ("single_user_offload", "paged_serve_offload"))
              for k in ("dense_w4a8_matmul", "dense_w4a8_ffn",
                        "w4a8_ffn_mma_kernel", "w4a8_mma_kernel")),
            ("mla_decode_fused", ("single_user_offload",)),
            *((k, ("paged_serve_offload",))
              for k in ("mla_paged_decode", "mla_paged_prefill")),
            *((k, ("single_user_streamed",))
              for k in ("gathered_quant_matmul", "quant_gemv_kernel")),
            # speculation: the verify step's k + 1 rows on the tensor-core
            # kernels, the one-token draft steps on the GEMVs and row 5;
            # the MTP head's decode attention on row 6
            *((k, ("speculative", "draft_spec"))
              for k in SPEC_KERNELS + SPEC_ROUTED),
            *((k, ("mtp", "mtp_fused")) for k in MTP_KERNELS + MTP_ROUTED),
            # sparse serving: rows 1-4 and the paged prefill (row 14); the
            # sparse decode in plain PyTorch where row 12 ran
            *((k, ("sparse_serve",))
              for k in SPARSE_KERNELS + ("mla_prefill_mma_kernel",)),
            *((k, ("sparse_offload",))
              for k in ("dense_w4a8_matmul", "dense_w4a8_ffn",
                        "mla_paged_prefill")),
            # parallelism: the fused shared experts on rows 1, 2, 4, 5 (row
            # 3 gone from the MoE layers: held in fused_shared_run); the
            # re-placed engine on rows 1-4, 12 and 14; every rank's EP run
            # on the same W4A8 rows and its TP run on rows 9-11 and 5 at 8
            # heads
            *((k, ("parallel_fused_shared",))
              for k in ("dense_w4a8_matmul", "gathered_w4a8_ffn",
                        "grouped_w4a8_ffn", "mla_decode_fused",
                        "w4a8_ffn_gemv_kernel")),
            *((k, ("parallel_rebalance",))
              for k in ("dense_w4a8_matmul", "gathered_w4a8_ffn",
                        "dense_w4a8_ffn", "mla_paged_decode",
                        "mla_paged_prefill")),
            *((k, tuple(f"parallel_ep_rank{r}"
                        for r in range(PARALLEL_RANKS)))
              for k in PARALLEL_EP_KERNELS),
            *((k, tuple(f"parallel_tp_rank{r}"
                        for r in range(PARALLEL_RANKS)))
              for k in PARALLEL_TP_KERNELS),
            # the training half: each rank's pipelined W4A8 forward on rows
            # 1 and 8, its pipelined int8 SFT, ZeRO-1 and EP steps on rows
            # 9 and 11 forward and 16 and 17 in the backward
            *((k, tuple(f"parallel_pp_rank{r}"
                        for r in range(PARALLEL_RANKS)))
              for k in PP_KERNELS),
            *((k, tuple(f"parallel_{p}_rank{r}"
                        for p in ("pp_sft", "zero1", "ep_sft")
                        for r in range(PARALLEL_RANKS)))
              for k in PARALLEL_SFT_KERNELS)):
        idle = [k for k in keys if paths[k].get(kernel, 0) <= 0]
        if idle:
            raise AssertionError(f"{kernel} launched on no call of {idle}")
    kernels = []
    for name in KERNELS + tuple(ROUTED_KERNELS):
        row = entries[name]
        total = sum(p.get(name, 0) for p in paths.values())
        if total <= 0 and name not in OFF_MAIN_PATHS:
            raise AssertionError(f"{name} launched on no main path")
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1],
            launches=total,
            **{f"launches_{k}": p.get(name, 0) for k, p in paths.items()},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            wrapper_ms=row["wrapper_ms"], kernel=row["kernel"],
            first_ms=row["first_ms"], fold=row.get("fold"),
            shape=row["shape"],
            **({"off_main_path": OFF_MAIN_PATHS[name]}
               if name in OFF_MAIN_PATHS else {}),
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
