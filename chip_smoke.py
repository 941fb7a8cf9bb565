#!/usr/bin/env python3
"""Smoke run of the gitax_torch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device: the card's name and power limit; TF32 off for the parity
     phases;
  2. build: the three CUDA kernels from gitax_torch/csrc (one nvcc each,
     in parallel), their compile reports, whether each one's SASS holds
     wgmma (HGMMA) and TMA loads (UTMALDG) (kernels 2 and 3 must), the
     decode kernel's cluster plans at M 1 to 1542, the vocab head's launch
     plan, and the wrappers' shared-memory formulas against the C side's;
  3. decode attention against its plain PyTorch version at the COCO
     path's shapes (GIT_LARGE beam-4, B=32: K=4, H=12, Dh=64, M=257,
     T=41), the VQA path's M=1201 and the video's M=1542, f32, bf16 and
     int8 memory, pos 0 to T-1, with and without the memory bias; its
     time per call beside the plain version's and its bound at the three
     memory lengths;
  4. fused attention against its plain version at the VQA path's shapes
     (encoder B=32 H=16 S 257/901/1201; prefill B=32 H=12 M=1201 Tp
     1/12/14; a video-length M=1542), f32 and bf16, in bf16 on a
     near-uniform and on a peaked softmax, and within 2^-6 of its largest
     output of the plain version run in bf16; its time per call
     beside the plain version's, beside F.scaled_dot_product_attention
     (a yardstick no path calls; the prefill with GIT's block mask as a
     boolean tensor) and beside its bound, and against the encoder's fast
     bf16 path (the A/B of the S >= 640 gate, at S 257/901/1201);
  5. the COCO slice: GIT_LARGE_COCO at full width with random EOS-gated
     weights through the port's CaptionEngine (bf16, weight-only int8,
     fast prefill, fast encoder softmax, beam 4) on 3 batches of 32
     random 224x224 images, counting kernel launches (S=257: the fused
     attention stays off);
  6. COCO f32 parity: the decode kernel path and the plain path give
     identical tokens;
  7. the VQA slice: GIT_LARGE_VQAv2 at full width and depth through the
     same engine: 128 (image, question) pairs, uint8 images MinMax-sized
     from 1:1, 4:3, 3:4 and 16:9 sources (grids 30x30, 30x40, 40x30,
     22x40), two question lengths, each through `generate_varshape`;
     pairs/s, encode, prefill and beam-step times, both kernels'
     launches against the batches and steps, and with --profile a
     profile of one batch (30x40, the long question);
  8. VQA f32 parity: the encoder and the prefill with the fused
     attention against without it, then beam search from each side with
     the decode kernel on and off: identical tokens;
  9. the fused int8 vocab head against its plain version at the beam
     step's shape (R = 32 x 4 = 128, W = 768, V = 30522) and at R 1, 128,
     200 x V 30522, 1100, 512, 1024, 513 x W 768, 1024, f32 and bf16, on
     N(0, 1) inputs and on a peaked set (one column per row far above the
     rest, in the last block), and at a ragged width (W = 80); its device
     time (bf16 and f32) beside the plain version's and its bound, its
     host cost per call, and a yardstick no path calls: torch.matmul of
     the bf16 hidden with the head widened to bf16 beforehand;
 10. the video slice: GIT_LARGE_VATEX (6 frames, M = 6 x 257 = 1542) at
     full width and depth through the same engine on 64 uint8 clips
     (2 batches of 32): clips/s, encode, prefill and beam-step times,
     kernels 1 and 2's launches against the steps and batches, and with
     --profile a profile of one batch;
 11. kernel 3 on the path: the same clips through `generate` with
     vocab_kernel on and off on the engine's settings, launches = beam
     steps; the first 4 head calls on the path (logits, block maxima and
     sums) against the plain head on the same hidden states; both loops'
     time per step, the share of clips whose tokens agree, the number of
     distinct outputs, and a profile of one batch on and off (with
     --profile also with the full-vocab sort the plain path took before
     its blocked top-k, for the sorts' device time before and after);
 12. video f32 parity: 4 clips, int8 head, vocab kernel on against off:
     the first 2 head calls against the plain head, identical tokens.
Each slice prints its peak device memory.
Prints the card's name and power limit, one JSON line describing the
kernels (launches on the main path; error, time, plain time, bound and
the one-call library time or null), then, last, the JSON line
{"ok": true, "device": {...}}.  Imports nothing of JAX and nothing of
the gitax package.
"""

import collections
import ctypes
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    "decode_attention": ("gitax_torch/csrc/decode_attention.cu",
                         "gitax/ops/decode_attention.py:147"),
    "flash_attention": ("gitax_torch/csrc/flash_attention.cu",
                        "gitax/ops/flash_attention.py:88"),
    "vocab_topk": ("gitax_torch/csrc/vocab_topk.cu", "gitax/ops/vocab_topk.py:63"),
}

# COCO path shapes of the decode-attention call (GIT_LARGE_COCO, B=32)
B, K, H, DH, M, T = 32, 4, 12, 64, 257, 41
# VQA path: the encoder's heads, the longest grid's sequence, the prefill
# shape of the long question bucket
ENC_H, ENC_S, PRE_M, PRE_TP = 16, 1201, 1201, 12
VQA_QUESTIONS = ("what is in the picture?",  # [CLS] + 6 tokens
                 "what color is the shirt of the man on the left side?")  # [CLS] + 13
VQA_WORDS = ["what", "is", "in", "the", "picture", "color", "shirt", "of", "man",
             "on", "left", "side"]
# MinMax sources (w, h) -> (question, grid): 30x30, 22x40 (315x560 cut to
# 308x560), 30x40, 40x30 at GIT_LARGE_VQAv2's 420/560
VQA_SOURCES = (((500, 500), 0), ((1920, 1080), 0), ((640, 480), 1), ((480, 640), 1))
# the video path: GIT_LARGE_VATEX's 6 frames per clip, 2 batches of 32
# clips; the vocab head's shape at the beam step: B*K rows of the hidden
# width against the vocab
FRAMES, CLIPS, VIDEO_BATCH = 6, 64, 32
HEAD_R, HEAD_W, HEAD_V = B * K, 768, 30522
# the H100 SXM's published peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# --profile: also one VQA and one video batch under torch.profiler
PROFILE = False


def bound(nbytes, flops, peak_flops):
    """(bound ms, 'bytes' or 'operations'): the least time the card could
    take, the larger of bytes over the memory rate and operations over the
    peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, iters, warmup=10):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, plain_iters, kernel_iters, warmup=10):
    """Times per call, plain/kernel/kernel/plain; (plain ms, kernel ms,
    the four readings)."""
    t = [cuda_time_ms(plain, plain_iters, warmup), cuda_time_ms(kernel, kernel_iters, warmup),
         cuda_time_ms(kernel, kernel_iters, warmup), cuda_time_ms(plain, plain_iters, warmup)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def device_ms(fn, iters, name, warmup=3):
    """Mean device time of the kernels whose name holds `name` that
    `iters` calls of `fn` launch, from torch.profiler: the kernel's own
    time, which a host clock around calls that launch faster than the host
    can issue them does not give.  The timed calls sit in a marked range
    with one more call before and after it, each side behind a
    synchronize, and only kernels that ran inside the range count.  The
    tracer does not keep every kernel record (runs on the H100 held 19 of
    20 and 15 of 20), and each record it keeps has the kernel's whole
    duration, so the mean is over the kernels it kept, and the count is
    printed when it is short.  The device's and the host's clocks are
    aligned only roughly, so one of the two untimed calls may show inside
    the range (a run held 61 for 60 calls): it is the same kernel on the
    same inputs and stays in the mean."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("gitax_timed_calls"):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [e.time_range for e in events
              if e.name == "gitax_timed_calls" and e.device_type == DeviceType.CPU]
    check(len(ranges) == 1, "the profile shows {} timed ranges".format(len(ranges)))
    lo, hi = ranges[0].start, ranges[0].end
    hit = [e.time_range for e in events if e.device_type == DeviceType.CUDA and name in e.name
           and lo <= e.time_range.start and e.time_range.end <= hi]
    check(1 <= len(hit) <= iters + 2, "the profile shows {} {} kernels inside the range of {} "
          "calls".format(len(hit), name, iters))
    if len(hit) < iters:
        log("device_ms: the trace kept {} of the {} {} kernels; the mean is over those".format(
            len(hit), iters, name))
    return sum(r.elapsed_us() for r in hit) / len(hit) / 1e3


def peak_memory(label, card):
    """Print the peak device memory PyTorch has allocated since the last
    `torch.cuda.reset_peak_memory_stats()`; a slice resets it when it
    starts, so its weights, activations and caches count."""
    import torch

    log("{}: peak device memory {:.1f} MiB allocated ({:.1f} MiB reserved) [{}]".format(
        label, torch.cuda.max_memory_allocated() / 2**20, torch.cuda.max_memory_reserved() / 2**20,
        card))


class DeviceSpans(object):
    """Records CUDA events around every call of a model method until
    `remove`; `ms()` gives each call's device span."""

    def __init__(self, model, name):
        import torch

        self.model, self.name, self.events = model, name, []
        orig = getattr(model, name)

        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig(*a, **kw)
            e.record()
            self.events.append((s, e))
            return out

        setattr(model, name, timed)

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.events]

    def remove(self):
        delattr(self.model, self.name)


def phase_build(card):
    import torch  # the ctypes libraries need the CUDA runtime loaded

    from gitax_torch.ops import cuda_build
    from gitax_torch.ops import decode_attention as da
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops import vocab_topk as vt

    t0 = time.perf_counter()
    cuda_build.build_all(list(KERNELS))
    log("build: {} in parallel in {:.1f} s ({})".format(
        " and ".join(KERNELS), time.perf_counter() - t0,
        ", ".join("{} {:.1f} s".format(n, cuda_build.build_seconds(n)) for n in KERNELS)))
    for name in KERNELS:
        for fn, line in ptxas_report(cuda_build.build_log(name)):
            log("build: {} {}: {}".format(name, fn, line))
    sass_report()
    # the wrappers size shared memory in Python; the launches size it in C
    lib = cuda_build.load("decode_attention")
    lib.gitax_decode_attention_smem.restype = ctypes.c_size_t
    for m in (1, M, 901, 1201, 1542):
        plans = []
        for mem_bytes, kind in ((2, "bf16"), (4, "f32"), (1, "int8")):
            cluster, chunk, smem = da.cluster_plan(m, K, DH, T, mem_bytes)
            c_bytes = lib.gitax_decode_attention_smem(K, DH, chunk, T, mem_bytes, cluster)
            check(smem == c_bytes, "decode_attention shared memory at M={}: wrapper "
                  "{} != kernel {}".format(m, smem, c_bytes))
            plans.append("{} {} x {} rows, {} bytes".format(kind, cluster, chunk, c_bytes))
        log("build: decode_attention M={} memory: CTAs per cluster x rows, shared memory per CTA "
            "(wrapper = kernel): {}".format(m, "; ".join(plans)))
    lib = cuda_build.load("flash_attention")
    lib.gitax_flash_attention_smem.restype = ctypes.c_size_t
    for bf16 in (False, True):
        c_bytes = lib.gitax_flash_attention_smem(int(bf16))
        check(fa.smem_bytes(bf16) == c_bytes, "flash_attention shared memory: "
              "wrapper {} != kernel {}".format(fa.smem_bytes(bf16), c_bytes))
        log("build: flash_attention {} shared memory {} bytes per block, wrapper = kernel, "
            "the same at S=901, 1240 and 1600 (it does not depend on S)".format(
                "bf16" if bf16 else "f32", c_bytes))
    lib = cuda_build.load("vocab_topk")
    lib.gitax_vocab_topk_smem.restype = ctypes.c_size_t
    plan = vt.tile_plan(HEAD_R, HEAD_W, HEAD_V)
    c_bytes = lib.gitax_vocab_topk_smem(1)
    check(plan["smem_bytes"] == c_bytes, "vocab_topk shared memory: wrapper {} != kernel {}".format(
        plan["smem_bytes"], c_bytes))
    log("build: vocab_topk bf16 at R={} W={} V={}: {} CTAs of {} threads in clusters of {} ({} "
        "blocks x {} row groups) on {} SMs, {} chunks of {} through {} stages, {} bytes of weight "
        "loads in flight per CTA, shared memory {} bytes per block (wrapper = kernel); f32 {} "
        "bytes".format(HEAD_R, HEAD_W, HEAD_V, plan["ctas"], plan["threads"], plan["cluster"],
                       plan["blocks"], plan["row_groups"],
                       torch.cuda.get_device_properties(0).multi_processor_count, plan["chunks"],
                       vt.K_CHUNK, plan["stages"], plan["loads_in_flight"], c_bytes,
                       lib.gitax_vocab_topk_smem(0)))


def sass_report():
    """Whether each kernel's SASS holds wgmma (HGMMA) and TMA tensor loads
    (UTMALDG), from cuobjdump where the toolkit has it; kernel 2 and
    kernel 3 must."""
    import shutil

    from gitax_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    for name in KERNELS:
        if not tool:
            log("build: {} SASS: HGMMA not checked, UTMALDG not checked (no cuobjdump)".format(name))
            continue
        out = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                             capture_output=True, text=True)
        check(out.returncode == 0, "cuobjdump failed on {}: {}".format(name, out.stderr[-500:]))
        found = {op: op in out.stdout for op in ("HGMMA", "UTMALDG", "UBLKCP")}
        log("build: {} SASS: {}".format(name, ", ".join(
            "{} {}".format(op, "yes" if hit else "no") for op, hit in found.items())))
        if name in ("flash_attention", "vocab_topk"):
            check(found["HGMMA"] and found["UTMALDG"], "{}'s SASS lacks HGMMA or UTMALDG".format(name))


def ptxas_report(text):
    """(function, line) for each register and spill line of an `nvcc
    -Xptxas -v` report, the function demangled with c++filt where there is
    one."""
    import re
    import shutil

    rows, fn = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?([\w.$]+)", line)
        if m:
            fn = m.group(1)
        elif "registers" in line or "spill" in line:
            rows.append((fn, line.split(":", 1)[-1].strip()))
    filt = shutil.which("c++filt")
    if filt and rows:
        names = sorted({f for f, _ in rows})
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            short = {n: d.replace("(anonymous namespace)::", "").split("(")[0]
                     for n, d in zip(names, out.stdout.splitlines())}
            rows = [(short[f], line) for f, line in rows]
    return rows


def decode_inputs(g, dtype, mem_int8, pos, m=M, bias=False):
    """One decode-attention call's inputs on the card, N(0, 0.25) values."""
    import torch

    from gitax_torch.ops.decode_attention import quantize_memory

    dev = torch.device("cuda")
    r = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    anc = torch.randint(0, K, (B * K, T), generator=g, dtype=torch.int32).to(dev)
    mem = r(B, H, m, 2 * DH)
    scale = None
    if mem_int8:
        mem, scale = quantize_memory(mem)
    else:
        mem = mem.to(dtype)
    return dict(q=r(B * K, H * DH).to(dtype), kv_new=r(B * K, H * 2 * DH).to(dtype),
                txt_kv=r(T, B * K, H * 2 * DH).to(dtype), anc=anc, pos=pos,
                mem_kv=mem, mem_bias=r(B, m) if bias else None, mem_scale=scale)


def check_decode_kernel():
    """Decode attention against the plain version on the same inputs at
    the COCO, VQA and video paths' memory lengths; the worst bf16 error
    against the plain version run in f32 at the COCO shape."""
    import torch

    from gitax_torch.ops.decode_attention import (
        cluster_plan,
        decode_attention_cuda,
        decode_attention_reference,
    )

    g = torch.Generator().manual_seed(0)
    kw = dict(beams=K, num_heads=H, head_dim=DH)

    def upcast(a):
        a = dict(a)
        for key in ("q", "kv_new", "txt_kv"):
            a[key] = a[key].float()
        if a["mem_kv"].dtype != torch.int8:
            a["mem_kv"] = a["mem_kv"].float()
        return a

    worst_main = 0.0
    kinds = (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
             ("bf16+int8mem", torch.bfloat16, True))
    # the COCO path's cases; the fourth build variant (f32 with int8
    # memory); the VQA path's memory (M=1201) and the video's (M=1542),
    # clusters of 5 and 7 CTAs, at the first and the last text slot; the
    # additive memory bias, which no path of the port passes yet
    cases = [(name, dtype, mem_int8, M, pos, False)
             for name, dtype, mem_int8 in kinds for pos in (0, 1, 20, T - 1)]
    cases += [("f32+int8mem", torch.float32, True, M, 20, False)]
    cases += [(name, dtype, mem_int8, m, pos, False)
              for m in (1201, 1542) for name, dtype, mem_int8 in kinds for pos in (0, T - 1)]
    cases += [(name + "+bias", dtype, mem_int8, m, 12, True)
              for m in (M, 1542) for name, dtype, mem_int8 in kinds]
    for name, dtype, mem_int8, m, pos, bias in cases:
        a = decode_inputs(g, dtype, mem_int8, pos, m, bias)
        label = "{:18s} M={:4d} pos={:2d} (cluster {})".format(
            name, m, pos, cluster_plan(m, K, DH, T, a["mem_kv"].element_size())[0])
        ker_cache, ref_cache = a["txt_kv"].clone(), a["txt_kv"].clone()
        ctx = decode_attention_cuda(**dict(a, txt_kv=ker_cache), **kw)
        ref = decode_attention_reference(**dict(a, txt_kv=ref_cache), **kw)
        torch.cuda.synchronize()
        check(torch.equal(ker_cache, ref_cache), "{}: cache differs".format(label))
        if dtype == torch.float32:
            # same f32 math, other summation order
            err = (ctx - ref).abs().max().item()
            check(torch.allclose(ctx, ref, atol=1e-5, rtol=1e-5),
                  "{}: ctx err {}".format(label, err))
            log("decode kernel {}: cache bit-equal, max|ctx-plain| {:.3e} "
                "(tol 1e-5 abs + 1e-5 rel)".format(label, err))
            continue
        # bf16: against the plain version run in f32 on the same bf16
        # inputs.  The kernel rounds each probability to bf16 (rel 2^-8),
        # int8 memory is dequantized in bf16 (rel 2^-8), and the context
        # is cast to bf16 once (rel 2^-8): tol 2^-7 of max|v| abs + 2^-7
        # rel covers them.  Against the plain version in bf16, which
        # rounds at the same points, the kernel may differ by an ulp of
        # the context or of a probability: within 2^-6 of max|ctx|
        ref32 = decode_attention_reference(**dict(upcast(a), txt_kv=a["txt_kv"].float().clone()), **kw)
        same = (ctx.float() - ref.float()).abs().max().item()
        same_tol = ref32.abs().max().item() / 64
        err = (ctx.float() - ref32).abs().max().item()
        vmax = ref_cache.float().abs().max().item()
        if mem_int8:
            vmax = max(vmax, 127 * a["mem_scale"].max().item())
        else:
            vmax = max(vmax, a["mem_kv"].float().abs().max().item())
        atol = vmax / 128
        check(torch.allclose(ctx.float(), ref32, atol=atol, rtol=1 / 128),
              "{}: ctx err {} vs f32 plain".format(label, err))
        check(same <= same_tol, "{}: max|ctx-plain_bf16| {} > max|plain_f32|/64 {}".format(
            label, same, same_tol))
        if name == "bf16" and m == M:
            worst_main = max(worst_main, err)
        log("decode kernel {}: cache bit-equal, max|ctx-plain_f32| {:.3e} (tol {:.3e} abs + "
            "2^-7 rel), max|ctx-plain_bf16| {:.3e} (tol {:.3e}, max|ctx|/64)".format(
                label, err, atol, same, same_tol))
        del a, ker_cache, ref_cache, ctx, ref, ref32
    torch.cuda.empty_cache()
    return worst_main


def phase_decode_kernel(card):
    """Decode attention against the plain version on the same inputs, and
    its time beside the plain version's and its bound."""
    import torch

    from gitax_torch.ops.decode_attention import decode_attention_cuda, decode_attention_reference

    worst_main = check_decode_kernel()
    g = torch.Generator().manual_seed(0)
    kw = dict(beams=K, num_heads=H, head_dim=DH)
    # time per call in bf16 at pos=12 (a caption of ~12 tokens) at the
    # COCO path's M=257, the VQA path's 1201 and the video's 1542; 6
    # memory buffers in turn, as the 6 decoder layers read them, so the
    # memory K/V does not sit in the 50 MB L2 from the call before
    out = {}
    for m in (M, 1201, 1542):
        layers = [decode_inputs(g, torch.bfloat16, False, 12, m) for _ in range(6)]
        it = {"i": 0}

        def run(fn):
            def call():
                a = layers[it["i"] % 6]
                it["i"] += 1
                fn(**a, **kw)
            return call

        plain_ms, call_ms, t = in_turns(run(decode_attention_reference), run(decode_attention_cuda),
                                        20 if m > M else 60, 300)
        ker_ms = device_ms(run(decode_attention_cuda), 60, "decode_attention")
        # bytes: the memory K/V, the live text rows the ancestry selects
        # (k|v), q, the new rows read and written into the cache, ctx;
        # operations: q.k and p.v over [memory ; live text], f32
        npos = 12 + 1
        mem_bytes = B * H * m * 2 * DH * 2
        nbytes = mem_bytes + B * K * H * npos * 2 * DH * 2 + B * K * H * DH * 2 * 2 \
            + B * K * H * 2 * DH * 2 * 2
        bound_ms, bound_by = bound(nbytes, 2 * 2 * B * K * H * (m + npos) * DH, F32_FLOPS)
        log("decode kernel time, bf16 B={} K={} H={} Dh={} M={} T={} pos=12: kernel {:.4f} ms "
            "on the device (profiler), {:.4f} ms per call back to back (events, host launch "
            "included); plain {:.4f} ms per call (plain,kernel,kernel,plain = {}); bound {:.4f} ms "
            "({}: {:.1f} MB), {:.1%} of it; memory K/V {:.0f} GB/s [{}]".format(
                B, K, H, DH, m, T, ker_ms, call_ms, plain_ms, ["%.4f" % x for x in t], bound_ms,
                bound_by, nbytes / 1e6, bound_ms / ker_ms, mem_bytes / (ker_ms * 1e-3) / 1e9, card))
        out[m] = dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del layers
    torch.cuda.empty_cache()
    # no single PyTorch call does the ancestry gather, the in-place cache
    # write and one softmax over [memory ; text]
    return dict(max_abs_err=worst_main, **out[M], library_ms=None)


def check_flash_kernel():
    """Fused attention against the plain version on the same inputs at the
    VQA and video paths' shapes, f32 and bf16; the worst bf16 error
    against the plain version run in f32 on the VQA shapes."""
    import torch

    from gitax_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(1)

    def qkv_input(b, s, h, dtype, qk_std):
        scale = torch.tensor([qk_std] * (2 * h * DH) + [0.5] * (h * DH))
        return (torch.randn(b, s, 3 * h * DH, generator=g) * scale).cuda().to(dtype)

    def masked_input(b, h, t, dtype, qk_std):
        return [(torch.randn(b, t, h * DH, generator=g) * std).cuda().to(dtype)
                .unflatten(2, (h, DH)).transpose(1, 2) for std in (qk_std, qk_std, 0.5)]

    worst_main = 0.0
    cases = [("encoder S={}".format(s), "qkv", B, ENC_H, s, 0) for s in (901, ENC_S)]
    cases += [("prefill M={} Tp={}".format(PRE_M, tp), "masked", B, H, PRE_M + tp, PRE_M)
              for tp in (1, PRE_TP)]
    cases += [("video M=1542 Tp=1", "masked", B, H, 1543, 1542)]
    # bf16 only: the COCO grid's S=257 and the long VQA question's prefill
    # (M=1201 + Tp=14 = 1215), two more ragged ends
    bf16_cases = [("encoder S=257", "qkv", B, ENC_H, 257, 0),
                  ("prefill M=1201 Tp=14", "masked", B, H, 1215, PRE_M)]
    # q and k of std 0.5 give scores of std 0.25: a near-uniform softmax
    # whose outputs are ~0.015, the mean of ~1200 rows of v.  In bf16 also
    # std 4 (scores of std 16): a few columns carry each row, outputs are
    # of the order of v, and most tiles hold exponentials below 2^-100,
    # which take the kernel's __fdiv_rn branch
    runs = [(torch.float32, "spread", 0.5, cases)]
    runs += [(torch.bfloat16, regime, std, cases + bf16_cases)
             for regime, std in (("spread", 0.5), ("peaked", 4.0))]
    for dtype, regime, qk_std, run_cases in runs:
        for name, entry, b, h, s, m in run_cases:
            if entry == "qkv":
                qkv = qkv_input(b, s, h, dtype, qk_std)
                out = fa.flash_qkv_attention(qkv, h).unflatten(2, (h, DH)).transpose(1, 2)
                q, k, v = [x.transpose(1, 2) for x in qkv.unflatten(2, (3, h, DH)).unbind(2)]
            else:
                q, k, v = masked_input(b, h, s, dtype, qk_std)
                out = fa.fused_attention(q, k, v, m, True)
            torch.cuda.synchronize()
            ref32 = fa.attention_reference(q.float(), k.float(), v.float(), m, entry == "masked")
            err = (out.float() - ref32).abs().max().item()
            if dtype == torch.float32:
                # same f32 math, other summation order
                check(torch.allclose(out, ref32, atol=1e-5, rtol=1e-5),
                      "flash {} f32: err {}".format(name, err))
                log("flash kernel f32  {:20s}: max|out-plain| {:.3e} (tol 1e-5 abs + 1e-5 rel)".format(
                    name, err))
            else:
                # against the plain version run in f32 on the same bf16
                # inputs: the kernel rounds each probability and the
                # context to bf16 once each (rel 2^-8), so 2^-7 of max|v|
                # abs + 2^-7 rel covers them.  That bound is loose where
                # the outputs are small: against the plain version in
                # bf16, which rounds at the same points, the kernel may
                # differ by an ulp of the context or of a probability,
                # within 2^-6 of max|output| (a skipped K tile or a text
                # row that sees the future is off by more)
                ref = fa.attention_reference(q, k, v, m, entry == "masked")
                same = (out.float() - ref.float()).abs().max().item()
                atol = v.float().abs().max().item() / 128
                same_tol = ref32.abs().max().item() / 64
                label = "flash {} {} bf16".format(name, regime)
                check(torch.allclose(out.float(), ref32, atol=atol, rtol=1 / 128),
                      "{}: err {} vs f32 plain".format(label, err))
                check(same <= same_tol, "{}: max|out-plain_bf16| {} > max|plain_f32|/64 {}".format(
                    label, same, same_tol))
                if "video" not in name and regime == "spread":
                    worst_main = max(worst_main, err)
                log("flash kernel bf16 {:20s} {}: max|out-plain_f32| {:.3e} (tol {:.3e} abs + 2^-7 "
                    "rel), max|out-plain_bf16| {:.3e} (tol {:.3e}, max|out|/64)".format(
                        name, regime, err, atol, same, same_tol))
            del q, k, v, out, ref32
    torch.cuda.empty_cache()
    return worst_main


def phase_flash_kernel(card):
    """Fused attention against the plain version on the same inputs, and
    its time beside the plain version's and the fast bf16 path's."""
    import torch

    from gitax_torch.models.nn import attention_weights, merge_heads, split_heads
    from gitax_torch.ops import flash_attention as fa

    worst_main = check_flash_kernel()
    g = torch.Generator().manual_seed(1)

    def qkv_input(b, s, h, dtype):
        return (torch.randn(b, s, 3 * h * DH, generator=g) * 0.5).cuda().to(dtype)

    def heads(qkv, h):
        return [x.transpose(1, 2) for x in qkv.unflatten(2, (3, h, DH)).unbind(2)]

    def masked_input(b, h, t, dtype):
        return [(torch.randn(b, t, h * DH, generator=g) * 0.5).cuda().to(dtype)
                .unflatten(2, (h, DH)).transpose(1, 2) for _ in range(3)]

    # times per call in bf16 at the VQA path's shapes, against the plain
    # version and against one PyTorch call of the same function,
    # F.scaled_dot_product_attention (a yardstick only: no path calls it;
    # its probabilities are not rounded before P.V, and the masked entry
    # hands it GIT's block mask as a boolean tensor)
    import torch.nn.functional as F

    def attn_bound(b, h, s, m, masked):
        """(bound ms, bound_by, GFLOP): the q.k and p.v products over the
        columns each row sees, against q, k, v read once and o written."""
        if masked:
            seen = m * m + sum(r + 1 for r in range(m, s))
        else:
            seen = s * s
        flops = 4 * b * h * seen * DH
        return bound(4 * b * h * s * DH * 2, flops, BF16_FLOPS) + (flops / 1e9,)

    def report(label, b, h, s, m, masked, ker_ms, others):
        bound_ms, bound_by, gflop = attn_bound(b, h, s, m, masked)
        log("flash kernel time, bf16 {} B={} H={} S={} Dh={}: kernel {:.4f} ms on the device "
            "(profiler); {}; "
            "bound {:.4f} ms ({}: {:.1f} GFLOP), {:.1%} of it, {:.1f} TFLOP/s [{}]".format(
                label, b, h, s, DH, ker_ms, "; ".join(others), bound_ms, bound_by, gflop,
                bound_ms / ker_ms, gflop / ker_ms, card))
        return bound_ms, bound_by

    def block_mask(s, m):
        idx = torch.arange(s, device="cuda")
        row, col = idx[:, None], idx[None, :]
        return ~((col >= m) & ((row < m) | (col > row)))  # True: attend

    qkv = qkv_input(B, ENC_S, ENC_H, torch.bfloat16)
    q, k, v = heads(qkv, ENC_H)
    plain_ms, _, t = in_turns(lambda: fa.attention_reference(q, k, v),
                              lambda: fa.flash_qkv_attention(qkv, ENC_H), 5, 20, warmup=3)
    ker_ms = device_ms(lambda: fa.flash_qkv_attention(qkv, ENC_H), 20, "flash_attention")
    # in_turns puts its first argument at the ends: kernel,SDPA,SDPA,kernel
    _, library_ms, t2 = in_turns(lambda: fa.flash_qkv_attention(qkv, ENC_H),
                                 lambda: F.scaled_dot_product_attention(q, k, v), 20, 20, warmup=3)
    bound_ms, bound_by = report("encoder", B, ENC_H, ENC_S, 0, False, ker_ms, [
        "plain {:.4f} ms (plain,kernel,kernel,plain = {})".format(plain_ms, ["%.4f" % x for x in t]),
        "SDPA {:.4f} ms (kernel,SDPA,SDPA,kernel = {})".format(library_ms,
                                                               ["%.4f" % x for x in t2])])
    del qkv, q, k, v
    for m, tp in ((PRE_M, PRE_TP), (1542, 1)):
        s = m + tp
        qm, km, vm = masked_input(B, H, s, torch.bfloat16)
        allowed = block_mask(s, m)
        pplain, _, t = in_turns(lambda: fa.attention_reference(qm, km, vm, m, True),
                                lambda: fa.fused_attention(qm, km, vm, m, True), 5, 20, warmup=3)
        pker = device_ms(lambda: fa.fused_attention(qm, km, vm, m, True), 20, "flash_attention")
        _, psdpa, t2 = in_turns(
            lambda: fa.fused_attention(qm, km, vm, m, True),
            lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=allowed), 20, 20, warmup=3)
        report("prefill M={} Tp={}".format(m, tp), B, H, s, m, True, pker, [
            "plain {:.4f} ms (plain,kernel,kernel,plain = {})".format(
                pplain, ["%.4f" % x for x in t]),
            "SDPA with the boolean block mask {:.4f} ms (kernel,SDPA,SDPA,kernel = {})".format(
                psdpa, ["%.4f" % x for x in t2])])
        del qm, km, vm, allowed
    torch.cuda.empty_cache()

    # the A/B of the S >= 640 gate: the kernel against the encoder's other
    # path, the fast bf16 scores and softmax (nn.self_attention, fast=True),
    # both from the fused projection to the merged context
    for s in (257, 901, ENC_S):
        qkv = qkv_input(B, s, ENC_H, torch.bfloat16)

        def fast_path():
            q, k, v = (split_heads(x, ENC_H) for x in qkv.chunk(3, dim=-1))
            return merge_heads(torch.matmul(attention_weights(q, k, fast=True).to(v.dtype), v))

        fast_ms, gker, t = in_turns(fast_path, lambda: fa.flash_qkv_attention(qkv, ENC_H), 20, 20,
                                    warmup=3)
        log("gate A/B, bf16 encoder B={} H={} S={}: kernel {:.4f} ms, fast bf16 path {:.4f} ms "
            "(fast,kernel,kernel,fast = {}) [{}]".format(B, ENC_H, s, gker, fast_ms,
                                                         ["%.4f" % x for x in t], card))
    return dict(max_abs_err=worst_main, ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def build_model(device, dtype, cpu_model):
    from gitax_torch.models.git import GitModel

    model = GitModel(cpu_model.cfg, device=device, dtype=dtype)
    model.load_state_dict(cpu_model.state_dict())
    return model


def random_model(name, seed, gate):
    """Random weights whose EOS row dominates from text position `gate`
    on (positions count the prefix)."""
    import torch

    from gitax_torch.models.config import config_from_param, get_model_param
    from gitax_torch.models.git import GitModel, eos_gate_

    cfg = config_from_param(dict(get_model_param(name), fast_softmax=True))
    t0 = time.perf_counter()
    model = GitModel(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))
    eos_gate_(model, gate=gate)
    log("weights: {} random init + EOS gate at {} in {:.1f} s".format(
        name, gate, time.perf_counter() - t0))
    return model


def phase_coco_slice(card, cpu_model, tok):
    """GIT_LARGE_COCO through the port's CaptionEngine, as served."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.runtime.engine import CaptionEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model("cuda", torch.bfloat16, cpu_model)
    engine = CaptionEngine(model, tok, batch_size=32,
                           beam=BeamSearchConfig(num_beams=4, max_steps=24),
                           dtype=torch.bfloat16, int8=True, fast_prefill=True,
                           decode_kernel=True)
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(96)]
    prefixes = [[tok.cls_token_id]] * len(images)
    engine.generate_batch(images[:32], prefixes[:32])  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    steps_t = DeviceSpans(model, "decode_step")  # 6 layers + head each
    decode_attention.launches = 0
    fa.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    handle = engine.dispatch(images, prefixes)
    captions = engine.resolve(handle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, flash_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    steps_t.remove()

    seqs = torch.cat([s.cpu() for _, bucket in handle[1] for s in bucket])
    # T_max 41 = [CLS] + max_text_len 40; the [CLS] prefix is stripped
    check(seqs.shape == (96, 40), "sequences shape {}".format(tuple(seqs.shape)))
    lengths = (seqs != engine.beam.eos_id).sum(1).float()
    check(len(captions) == 96 and all(isinstance(c, str) and c for c in captions),
          "empty or missing captions")
    n_layers = model.cfg.num_layers
    check(steps > 0 and launches == n_layers * steps,
          "decode_attention launches {} != {} layers x {} steps".format(launches, n_layers, steps))
    # S=257 < 640: the fused attention's gate leaves the 224 px path alone
    check(flash_launches == 0, "flash_attention launched {} times at S=257".format(flash_launches))
    step_ms = sum(steps_t.ms()) / len(steps_t.events)
    log("coco slice: 3 batches x 32 GIT_LARGE_COCO captions, {} beam steps, decode_attention "
        "launches {} = {} x {}, flash_attention launches 0 (S=257)".format(
            steps, launches, n_layers, steps))
    log("coco slice: {:.2f} images/s, mean decode length {:.2f} tokens, {:.3f} ms per beam "
        "step (device, 6 layers + head) [{}]".format(96 / seconds, lengths.mean().item(),
                                                     step_ms, card))
    log("coco slice: sample captions: {}".format(captions[:2]))
    peak_memory("coco slice", card)
    del engine, model
    torch.cuda.empty_cache()
    return launches, images


def normalized(images, dtype):
    import numpy as np
    import torch

    from gitax_torch.runtime.engine import CLIP_MEAN, CLIP_STD

    x = torch.from_numpy(np.stack(images)).cuda().to(dtype) / 255.0
    return (x - torch.tensor(CLIP_MEAN, device="cuda", dtype=dtype)) / torch.tensor(
        CLIP_STD, device="cuda", dtype=dtype)


def phase_coco_f32_parity(cpu_model, images):
    """f32 weights: decode kernel path and plain path, identical tokens.
    Uses bench.py's search setting (a 24-token buffer whose length norm
    lets is_done stop the loop early), the other side of the engine's
    rule."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig

    model = build_model("cuda", torch.float32, cpu_model)
    x = normalized(images[:16], torch.float32)
    beam = BeamSearchConfig(num_beams=4, max_steps=24)
    out, steps = {}, {}
    for kernel in (True, False):
        model.decode_step_calls = 0
        out[kernel] = model.generate(x, beam=beam, decode_kernel=kernel)
        steps[kernel] = model.decode_step_calls
    (seq_k, lp_k), (seq_p, lp_p) = out[True], out[False]
    check(seq_k.shape == (16, 24) and torch.isfinite(lp_k).all().item(),
          "f32 output shape {} or non-finite logprobs".format(tuple(seq_k.shape)))
    check(torch.equal(seq_k, seq_p), "f32 tokens differ between kernel and plain paths")
    err = (lp_k - lp_p).abs().max().item()
    check(err <= 1e-4, "f32 logprobs differ by {}".format(err))
    log("coco f32 parity: 16 images, kernel and plain paths: tokens identical, logprobs within "
        "{:.2e} (tol 1e-4), {} beam steps each (buffer 24), mean length {:.2f}".format(
            err, steps[True], (seq_k != 102).sum(1).float().mean().item()))
    del model
    torch.cuda.empty_cache()


def vqa_pairs(engine, cfg):
    """128 (uint8 image, prefix) pairs: 32 per MinMax source, questions by
    source, sized by the reference's MinMaxResizeForTest."""
    import numpy as np

    from gitax_torch.preprocess.transforms import min_max_resize_size

    rng = np.random.RandomState(1)
    crop, ratio_max = 420, 560  # GIT_LARGE_VQAv2's test_crop_size, test_respect_ratio_max
    check(cfg.encoder.input_resolution == crop, "not the 420 px config")
    pairs = []
    for source, qi in VQA_SOURCES:
        h, w = min_max_resize_size(source, crop, ratio_max)
        prefix = engine.encode_prefix(VQA_QUESTIONS[qi])
        pairs += [(rng.randint(0, 256, (h, w, 3), dtype=np.uint8), prefix) for _ in range(32)]
    return pairs


def run_vqa(engine, pairs):
    """Group the pairs by prefix length (one length per dispatch, as
    gitax's run_vqa_tsv buckets them) and run each group through
    `generate_varshape`'s two halves; (answers in pair order, handles)."""
    groups = collections.defaultdict(list)
    for i, (_, prefix) in enumerate(pairs):
        groups[len(prefix)].append(i)
    answers, handles = [None] * len(pairs), []
    for tp, idx in sorted(groups.items()):
        handle = engine.dispatch_varshape([pairs[i][0] for i in idx], [pairs[i][1] for i in idx])
        for i, answer in zip(idx, engine.resolve(handle)):
            answers[i] = answer
        handles.append((tp, handle))
    return answers, handles


def phase_vqa_slice(card, cpu_model, tok):
    """GIT_LARGE_VQAv2 high-res VQA through the port's CaptionEngine."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.runtime.engine import CaptionEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model("cuda", torch.bfloat16, cpu_model)
    cfg = model.cfg
    engine = CaptionEngine(model, tok, batch_size=32, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                           dtype=torch.bfloat16, int8=True, fast_prefill=True, decode_kernel=True)
    pairs = vqa_pairs(engine, cfg)
    p = cfg.encoder.patch_size
    grids = sorted({(a.shape[0] // p, a.shape[1] // p) for a, _ in pairs})
    check(grids == [(22, 40), (30, 30), (30, 40), (40, 30)], "grids {}".format(grids))
    run_vqa(engine, pairs)  # warm-up at every grid: cuBLAS, allocator
    torch.cuda.synchronize()

    spans = {name: DeviceSpans(model, name) for name in ("encode_images", "prefill", "decode_step")}
    decode_attention.launches = 0
    fa.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    answers, handles = run_vqa(engine, pairs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    d_launches, f_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    times = {name: s.ms() for name, s in spans.items()}
    for s in spans.values():
        s.remove()

    n_enc, n_pre = len(times["encode_images"]), len(times["prefill"])
    check(n_enc == n_pre == 4, "{} encoder and {} prefill batches, not 4".format(n_enc, n_pre))
    want_f = cfg.encoder.layers * n_enc + cfg.num_layers * n_pre
    check(f_launches == want_f, "flash_attention launches {} != {} x {} encoder + {} x {} prefill "
          "batches".format(f_launches, cfg.encoder.layers, n_enc, cfg.num_layers, n_pre))
    check(steps > 0 and d_launches == cfg.num_layers * steps,
          "decode_attention launches {} != {} layers x {} steps".format(
              d_launches, cfg.num_layers, steps))
    lengths = []
    for tp, (n, dispatched) in handles:
        for idxs, seqs in dispatched:
            for s in seqs:
                # buffer max(40, tp + 40), the prefix stripped
                check(tuple(s.shape) == (32, 40), "tp={} sequences {}".format(tp, tuple(s.shape)))
                lengths.append((s != engine.beam.eos_id).sum(1).float().cpu())
    lengths = torch.cat(lengths)
    check(len(answers) == len(pairs) and all(isinstance(a, str) and a for a in answers),
          "empty or missing answers")
    log("vqa slice: {} GIT_LARGE_VQAv2 pairs, grids {}, prefix lengths {}, {} encoder and {} "
        "prefill batches of 32, {} beam steps".format(
            len(pairs), ["{}x{}".format(*g) for g in grids], [tp for tp, _ in handles],
            n_enc, n_pre, steps))
    log("vqa slice: flash_attention launches {} = 24 x {} + 6 x {}; decode_attention launches "
        "{} = 6 x {}".format(f_launches, n_enc, n_pre, d_launches, steps))
    log("vqa slice: {:.2f} pairs/s, encode {:.2f} ms and prefill {:.2f} ms per batch of 32, "
        "{:.3f} ms per beam step (device events), mean answer length {:.2f} tokens [{}]".format(
            len(pairs) / seconds, sum(times["encode_images"]) / n_enc,
            sum(times["prefill"]) / n_pre, sum(times["decode_step"]) / len(times["decode_step"]),
            lengths.mean().item(), card))
    log("vqa slice: encode ms per batch {}, prefill ms per batch {}".format(
        ["%.2f" % x for x in times["encode_images"]], ["%.2f" % x for x in times["prefill"]]))
    log("vqa slice: sample answers: {}".format([answers[0], answers[-1]]))
    peak_memory("vqa slice", card)
    # with --profile, where one batch's device time goes: the 32 pairs at
    # the 30x40 grid (S=1201) with the long question, after the timed run
    if PROFILE:
        batch = [pair for pair in pairs if pair[0].shape[:2] == (420, 560)][:32]
        profile_batch("vqa", card, lambda: engine.generate_varshape(
            [a for a, _ in batch], [pfx for _, pfx in batch]))
    del engine, model
    torch.cuda.empty_cache()
    return d_launches, f_launches, pairs


def profile_batch(label, card, fn):
    """One call of `fn` under torch.profiler: device kernel time in all,
    the port's kernels' share and the top entries by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    total = sum(dev_us(e) for e in kernels) / 1e3
    check(total > 0, "the {} profile shows no device time".format(label))
    parts = []
    for name in KERNELS:
        hit = [e for e in kernels if name in e.key]
        ms = sum(dev_us(e) for e in hit) / 1e3
        parts.append("{} {:.2f} ms x{} ({:.1%})".format(name, ms, sum(e.count for e in hit),
                                                        ms / total))
    log("{} profile, one batch: wall {:.2f} ms under the profiler, device kernel time {:.2f} ms "
        "({:.1%} busy); {} [{}]".format(label, wall, total, total / wall, ", ".join(parts), card))
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log("{} profile:   {:8.3f} ms {:5.1%} x{:5d}  {}".format(
            label, dev_us(e) / 1e3, dev_us(e) / 1e3 / total, e.count, e.key[:90]))


def phase_vqa_f32_parity(cpu_model, pairs):
    """f32 weights, 8 images at 420x560 with one prefix: the encoder and
    the prefill with the fused attention (explicit flash=True, which gitax
    allows in f32) against without it; then beam search from each side,
    the decode kernel on and off: identical tokens."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import flash_attention as fa

    model = build_model("cuda", torch.float32, cpu_model)
    chosen = [(a, p) for a, p in pairs if a.shape[:2] == (420, 560)][:8]
    check(len(chosen) == 8, "8 images at 420x560")
    x = normalized([a for a, _ in chosen], torch.float32)
    prefix = torch.tensor([p for _, p in chosen], device="cuda")
    tp = prefix.shape[1]
    fa.launches = 0
    with torch.inference_mode():
        feats = {flash: model.encode_images(x, flash=flash) for flash in (True, False)}
        enc_err = (feats[True] - feats[False]).abs().max().item()
        check(enc_err <= 1e-4, "encoder flash vs plain: {}".format(enc_err))
        pre = {flash: model.prefill(feats[False], prefix, tp + 40, flash=flash, kernel_memory=True)
               for flash in (True, False)}
    check(fa.launches == model.cfg.encoder.layers + model.cfg.num_layers,
          "flash launches {} in the f32 parity calls".format(fa.launches))
    (lg_f, c_f), (lg_p, c_p) = pre[True], pre[False]
    lg_err = (lg_f - lg_p).abs().max().item()
    check(lg_err <= 1e-4, "prefill logits flash vs plain: {}".format(lg_err))
    # the first layer's k|v come before any attention: the two paths cache
    # the same rows bit for bit; later layers carry the attention's rounding
    check(torch.equal(c_f.txt_kv[0], c_p.txt_kv[0]) and torch.equal(c_f.mem_kv[0], c_p.mem_kv[0]),
          "prefill layer-0 cache differs between flash and plain")
    cache_err = max(max((a - b).abs().max().item() for a, b in zip(c_f.txt_kv, c_p.txt_kv)),
                    max((a - b).abs().max().item() for a, b in zip(c_f.mem_kv, c_p.mem_kv)))
    check(cache_err <= 1e-4, "prefill cache flash vs plain: {}".format(cache_err))
    log("vqa f32 parity: 8 images 420x560, Tp={}: encoder flash vs plain max|diff| {:.3e}, prefill "
        "logits {:.3e}, cache layer 0 bit-equal and all layers within {:.3e} (tol 1e-4)".format(
            tp, enc_err, lg_err, cache_err))
    beam = BeamSearchConfig(num_beams=4, max_steps=tp + 40, norm_max_length=1024)  # the engine's rule
    out = {}
    for flash in (True, False):
        for kernel in (True, False):
            out[flash, kernel] = model.generate(x, prefix, beam=beam, decode_kernel=kernel, flash=flash)
    seq0, lp0 = out[True, True]
    check(seq0.shape == (8, 40) and torch.isfinite(lp0).all().item(),
          "f32 output shape {} or non-finite logprobs".format(tuple(seq0.shape)))
    lp_err = 0.0
    for key, (seq, lp) in out.items():
        check(torch.equal(seq, seq0), "f32 tokens differ, flash/decode kernel {}".format(key))
        lp_err = max(lp_err, (lp - lp0).abs().max().item())
    check(lp_err <= 1e-4, "f32 logprobs differ by {}".format(lp_err))
    log("vqa f32 parity: beam 4 from the flash and the plain encoder+prefill, decode kernel on "
        "and off: tokens identical in all 4 runs, logprobs within {:.2e} (tol 1e-4), mean answer "
        "length {:.2f}".format(lp_err, (seq0 != 102).sum(1).float().mean().item()))


def check_vocab_call(label, h, q, sc, bz, logits, bmax, bsum):
    """One call of the fused vocab head against its plain version on the
    same inputs, at the stated tolerances; returns (max |logits - plain|,
    the same over each logit's magnitude)."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    r, v = h.shape[0], q.shape[1]
    ref, _, _ = vt.vocab_logits_topk_reference(h, q, sc, bz)
    nb = (v + vt.TILE - 1) // vt.TILE
    check(logits.shape == (r, nb * vt.TILE) and bmax.shape == bsum.shape == (r, nb),
          "{}: shapes {} {}".format(label, tuple(logits.shape), tuple(bmax.shape)))
    check(torch.isneginf(logits[:, v:]).all().item(), "{}: padding columns not -inf".format(label))
    # the same products (bf16 x bf16 and f32 x int8 are exact in f32),
    # summed in another order: tol 1e-5 of each logit's sum of
    # |products| * scale + |bias|
    mag = torch.matmul(h.float().abs(), q.float().abs()) * sc + bz.abs()
    err = (logits[:, :v] - ref[:, :v]).abs()
    rel = (err / mag).max().item()
    check(rel <= 1e-5, "{}: logits err {} of the magnitude".format(label, rel))
    # statistics of the kernel's own logits: bmax bit-equal
    _, own_max, own_sum = vt.block_stats(logits, vt.TILE)
    check(torch.equal(bmax, own_max), "{}: bmax is not the max of the kernel's own logits".format(
        label))
    sum_rel = ((bsum - own_sum).abs() / own_sum).max().item()
    lse = vt.combine_lse(bmax, bsum)
    lse_ref = torch.logsumexp(logits[:, :v], -1)
    lse_rel = ((lse - lse_ref).abs() / lse_ref.abs()).max().item()
    check(sum_rel <= 1e-6 and lse_rel <= 1e-6,
          "{}: bsum err {} or lse err {} (relative)".format(label, sum_rel, lse_rel))
    log("{}: max|logits-plain| {:.3e}, {:.2e} of the magnitude (tol 1e-5 of "
        "sum|h*q|*scale+|bias|), bmax bit-equal to its logits' block max, bsum {:.2e} and lse "
        "{:.2e} relative (tol 1e-6)".format(label, err.max().item(), rel, sum_rel, lse_rel))
    return err.max().item(), rel


def vocab_inputs(g, r, v, w, dtype, peaked=False):
    """One vocab-head call's inputs, made on the card from its generator
    `g`: a LayerNorm-scale hidden state, int8 values over their whole
    range, scales of a 0.02-std table (~4 sigma / 127).  The int8 [W, V]
    is vocab-major, the transpose of a row-major [V, W], as the port's
    int8 Linear stores the head.  peaked: each of the first rows gets a
    column of its own in the last 512-column block whose weights are
    127 sign(hidden) at a scale of 1e-3, a logit tens above every other,
    so the statistics of that block and the logsumexp hang on how the
    partial (max, sum) of a block's column halves are merged."""
    import torch

    q = torch.randint(-127, 128, (v, w), generator=g, dtype=torch.int8, device="cuda")
    h = torch.randn(r, w, generator=g, device="cuda").to(dtype)
    scale = torch.rand(v, generator=g, device="cuda") * 1e-3 + 1e-4
    if peaked:
        first = (v - 1) // 512 * 512
        n = min(r, v - first)
        q[first:first + n] = (torch.sign(h[:n].float()) * 127).to(torch.int8)
        scale[first:first + n] = 1e-3
    return h, q.t(), scale, torch.randn(v, generator=g, device="cuda") * 0.1


def check_vocab_kernel():
    """The fused vocab head against its plain version: one row, the beam
    step's 128 and more than one row group (200); the GIT vocab, a ragged
    small one, whole blocks only (512, 1024) and a block with one valid
    column (513); W 768 and 1024; f32 and bf16; N(0, 1) and peaked inputs.
    Returns the worst bf16 error at the beam step's shape."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    g = torch.Generator(device="cuda").manual_seed(2)
    worst_main, cases = 0.0, 0
    for w, r, v, dtype, peaked in itertools.product(
            (HEAD_W, 1024), (1, HEAD_R, 200), (HEAD_V, 1100, 512, 1024, 513),
            (torch.float32, torch.bfloat16), (False, True)):
        args = vocab_inputs(g, r, v, w, dtype, peaked)
        logits, bmax, bsum = vt.vocab_logits_topk_cuda(*args)
        torch.cuda.synchronize()
        err, _ = check_vocab_call("vocab kernel {:4s} R={:3d} V={:5d} W={:4d} {}".format(
            "f32" if dtype == torch.float32 else "bf16", r, v, w,
            "peaked" if peaked else "N(0,1)"), *args, logits, bmax, bsum)
        if peaked:
            # the peak is there: row 0's last block towers over its others
            rest = bmax[0, :-1].max().item() if bmax.shape[1] > 1 else 0.0
            check(bmax[0, -1].item() - rest > 20, "the peaked set has no peak: {} over {}".format(
                bmax[0, -1].item(), rest))
        if (r, v, w, dtype, peaked) == (HEAD_R, HEAD_V, HEAD_W, torch.bfloat16, False):
            worst_main = err
        cases += 1
        del args, logits, bmax, bsum
    # a width that is no multiple of the ring's 64-value chunk: TMA fills
    # the rest of the last chunk with zeros on both operands
    for dtype in (torch.float32, torch.bfloat16):
        args = vocab_inputs(g, 3, 1100, 80, dtype)
        out = vt.vocab_logits_topk_cuda(*args)
        torch.cuda.synchronize()
        check_vocab_call("vocab kernel {:4s} R=  3 V= 1100 W=  80 N(0,1)".format(
            "f32" if dtype == torch.float32 else "bf16"), *args, *out)
    torch.cuda.empty_cache()
    log("vocab kernel: {} cases hold (R 1/128/200 x V 30522/1100/512/1024/513 x W 768/1024 x "
        "f32/bf16 x N(0,1)/peaked), and W=80 in both types".format(cases))
    return worst_main


def phase_vocab_kernel(card):
    """The fused vocab head against its plain version on the same inputs,
    and the time per call of both."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    worst_main = check_vocab_kernel()
    g = torch.Generator(device="cuda").manual_seed(3)

    # time per call at the beam step's shape; 4 weight copies in turn (94
    # MB of int8), so that the 23.4 MB matrix is not left in the 50 MB L2
    # from the call before, as in the decode step, where the 6 layers'
    # weights and memory pass through L2 between two head calls
    nb = (HEAD_V + vt.TILE - 1) // vt.TILE
    it = {"i": 0}

    def run(fn, copies):
        def call():
            fn(*copies[it["i"] % 4])
            it["i"] += 1
        return call

    def moved(act_bytes):
        return HEAD_W * HEAD_V + HEAD_R * nb * vt.TILE * 4 + 2 * HEAD_R * nb * 4 \
            + HEAD_R * HEAD_W * act_bytes + 2 * HEAD_V * 4

    flops = 2 * HEAD_R * HEAD_W * HEAD_V
    copies = [vocab_inputs(g, HEAD_R, HEAD_V, HEAD_W, torch.bfloat16) for _ in range(4)]
    kernel = run(vt.vocab_logits_topk_cuda, copies)
    plain_ms, call_ms, t = in_turns(run(vt.vocab_logits_topk_reference, copies), kernel, 40, 200)
    ker_ms = device_ms(kernel, 60, "vocab_topk")
    # the products run in bf16 on the tensor cores (int8 widened)
    bound_ms, bound_by = bound(moved(2), flops, BF16_FLOPS)
    log("vocab kernel time, bf16 R={} W={} V={}: kernel {:.4f} ms on the device (profiler), "
        "{:.4f} ms per call back to back (events, host launch included); plain {:.4f} ms per call "
        "(plain,kernel,kernel,plain = {}); {:.1f} MB moved (int8 weights + f32 logits + stats) -> "
        "{:.0f} GB/s; bound {:.4f} ms ({}), {:.1%} of it [{}]".format(
            HEAD_R, HEAD_W, HEAD_V, ker_ms, call_ms, plain_ms, ["%.4f" % x for x in t],
            moved(2) / 1e6, moved(2) / (ker_ms * 1e-3) / 1e9, bound_ms, bound_by, bound_ms / ker_ms,
            card))
    # what a call costs the host, which bounds the beam step: 300 calls
    # back to back, the host clock before and after the synchronize
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(300):
        kernel()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log("vocab kernel host cost, bf16: {:.1f} us per call to enqueue (checks, two tensor maps, "
        "three outputs, the launch), {:.1f} us per call to the end of the last [{}]".format(
            (t1 - t0) / 300 * 1e6, (t2 - t0) / 300 * 1e6, card))
    # a yardstick no path calls and no one PyTorch call of the function:
    # cuBLAS on the head widened to bf16 beforehand (twice the weight
    # bytes; no scale, bias, -inf columns or statistics; bf16 logits)
    wide = [c[1].to(torch.bfloat16) for c in copies]

    def matmul():
        torch.matmul(copies[it["i"] % 4][0], wide[it["i"] % 4])
        it["i"] += 1

    mm_ms = [cuda_time_ms(matmul, 200), cuda_time_ms(matmul, 200)]
    mm_bytes = 2 * HEAD_W * HEAD_V + 2 * HEAD_R * HEAD_V + 2 * HEAD_R * HEAD_W
    log("vocab kernel yardstick, not the function and on no path: torch.matmul of the bf16 hidden "
        "with the head widened to bf16 beforehand {:.4f} and {:.4f} ms per call (events; {:.1f} MB "
        "moved, {:.0f} GB/s; no scale, bias, padding or statistics) beside the kernel's {:.4f} ms "
        "[{}]".format(mm_ms[0], mm_ms[1], mm_bytes / 1e6, mm_bytes / (min(mm_ms) * 1e-3) / 1e9,
                      ker_ms, card))
    del wide
    # the f32 parity path: plain FMAs outside the tensor cores
    f32_copies = [(c[0].float(),) + c[1:] for c in copies]
    del copies
    f32_ms = device_ms(run(vt.vocab_logits_topk_cuda, f32_copies), 20, "vocab_topk")
    f32_bound, f32_by = bound(moved(4), flops, F32_FLOPS)
    log("vocab kernel time, f32 (the parity path) R={} W={} V={}: kernel {:.4f} ms on the device "
        "(profiler); bound {:.4f} ms ({}: {:.1f} GFLOP of f32 FMA at 67 TFLOP/s), {:.1%} of it "
        "[{}]".format(HEAD_R, HEAD_W, HEAD_V, f32_ms, f32_bound, f32_by, flops / 1e9,
                      f32_bound / f32_ms, card))
    del f32_copies
    torch.cuda.empty_cache()
    # no single PyTorch call gives the scale, bias, -inf padding and the
    # per-tile max and sum of exponentials
    return dict(max_abs_err=worst_main, ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


class VocabCalls(object):
    """Records the first `n` calls of the fused vocab head that the
    decode step makes (inputs and outputs, copied) until `remove`, for
    `check_vocab_call` after the run."""

    def __init__(self, n):
        from gitax_torch.models import textual

        self.n, self.calls, self.orig = n, [], textual.vocab_logits_topk

        def recorded(*args):
            out = self.orig(*args)
            if len(self.calls) < self.n:
                self.calls.append([a.clone() for a in args] + [o.clone() for o in out])
            return out

        textual.vocab_logits_topk = recorded

    def remove(self):
        from gitax_torch.models import textual

        textual.vocab_logits_topk = self.orig


def video_model(seed):
    """GIT_LARGE_VATEX, random EOS-gated weights, with non-zero temporal
    embeddings: gitax initialises them to zeros, which would leave the
    frame order invisible."""
    import torch

    model = random_model("GIT_LARGE_VATEX", seed=seed, gate=12)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.img_temperal_embedding:
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    check(len(model.img_temperal_embedding) == FRAMES, "not a 6-frame config")
    return model


def phase_video_slice(card, cpu_model, tok):
    """GIT_LARGE_VATEX video captioning through the port's CaptionEngine."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.runtime.engine import CaptionEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model("cuda", torch.bfloat16, cpu_model)
    cfg = model.cfg
    engine = CaptionEngine(model, tok, batch_size=VIDEO_BATCH,
                           beam=BeamSearchConfig(num_beams=4, max_steps=40), dtype=torch.bfloat16,
                           int8=True, fast_prefill=True, decode_kernel=True)
    rng = np.random.RandomState(2)
    clips = [rng.randint(0, 256, (FRAMES, 224, 224, 3), dtype=np.uint8) for _ in range(CLIPS)]
    prefixes = [[tok.cls_token_id]] * CLIPS
    engine.generate_batch(clips[:VIDEO_BATCH], prefixes[:VIDEO_BATCH])  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    spans = {name: DeviceSpans(model, name) for name in ("encode_images", "prefill", "decode_step")}
    decode_attention.launches = 0
    fa.launches = 0
    vt.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    handle = engine.dispatch(clips, prefixes)
    captions = engine.resolve(handle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    d_launches, f_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    v_launches = vt.launches
    times = {name: s.ms() for name, s in spans.items()}
    for s in spans.values():
        s.remove()

    n_enc, n_pre = len(times["encode_images"]), len(times["prefill"])
    check(n_enc == n_pre == CLIPS // VIDEO_BATCH, "{} encoder and {} prefill batches".format(
        n_enc, n_pre))
    # the encoder runs 6 x 32 frames at S=257, below the fused attention's
    # gate; the prefill at M + 1 = 1543 takes it in each layer
    check(f_launches == cfg.num_layers * n_pre, "flash_attention launches {} != {} x {} prefill "
          "batches".format(f_launches, cfg.num_layers, n_pre))
    check(steps > 0 and d_launches == cfg.num_layers * steps,
          "decode_attention launches {} != {} layers x {} steps".format(d_launches, cfg.num_layers,
                                                                       steps))
    check(v_launches == 0, "the engine launched the vocab kernel {} times".format(v_launches))
    seqs = torch.cat([s.cpu() for _, bucket in handle[1] for s in bucket])
    check(seqs.shape == (CLIPS, 40), "sequences shape {}".format(tuple(seqs.shape)))
    check(len(captions) == CLIPS and all(isinstance(c, str) and c for c in captions),
          "empty or missing captions")
    lengths = (seqs != engine.beam.eos_id).sum(1).float()
    log("video slice: {} GIT_LARGE_VATEX clips of {} frames at 224x224 (M={}), {} batches of {}, "
        "{} beam steps; flash_attention launches {} = {} x {} (prefill; the encoder's S=257 stays "
        "below the gate); decode_attention launches {} = {} x {}".format(
            CLIPS, FRAMES, FRAMES * cfg.encoder.num_tokens, n_enc, VIDEO_BATCH, steps, f_launches,
            cfg.num_layers, n_pre, d_launches, cfg.num_layers, steps))
    log("video slice: {:.2f} clips/s, encode {:.2f} ms and prefill {:.2f} ms per batch of {}, "
        "{:.3f} ms per beam step (device events, 6 layers + head), mean decode length {:.2f} "
        "tokens [{}]".format(CLIPS / seconds, sum(times["encode_images"]) / n_enc,
                             sum(times["prefill"]) / n_pre, VIDEO_BATCH,
                             sum(times["decode_step"]) / len(times["decode_step"]),
                             lengths.mean().item(), card))
    log("video slice: {} distinct captions among {}; samples: {}".format(
        len(set(captions)), CLIPS, captions[:2]))
    peak_memory("video slice", card)
    if PROFILE:
        profile_batch("video", card, lambda: engine.generate_batch(clips[:VIDEO_BATCH],
                                                                   prefixes[:VIDEO_BATCH]))
    return model, engine, clips, d_launches, f_launches


def cls_prefix(x):
    """The engine's caption prefix, [CLS] per row, stripped from the
    output."""
    import torch

    return torch.full((x.shape[0], 1), 101, dtype=torch.long, device=x.device)


def phase_vocab_path(card, model, engine, clips):
    """Kernel 3 on the path: the same clips through `generate` with
    vocab_kernel on and off on the engine's settings; its first head calls
    against the plain head; a profile of one batch on and off."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    beam = engine.beam_for(1)
    check(model.vocab_kernel_applies(beam), "the vocab kernel's gates are off")
    batches = [clips[i:i + VIDEO_BATCH] for i in range(0, len(clips), VIDEO_BATCH)]
    torch.cuda.reset_peak_memory_stats()  # the model's weights stay allocated

    def run(vocab_kernel):
        spans = {name: DeviceSpans(model, name) for name in ("encode_images", "prefill", "generate")}
        model.decode_step_calls = 0
        out = []
        for batch in batches:
            x = normalized(batch, torch.bfloat16)
            out.append(model.generate(x, cls_prefix(x), beam=beam, dtype=torch.bfloat16,
                                      fast_prefill=True, decode_kernel=True,
                                      vocab_kernel=vocab_kernel)[0])
        torch.cuda.synchronize()
        times = {name: sum(s.ms()) for name, s in spans.items()}
        for s in spans.values():
            s.remove()
        steps = model.decode_step_calls
        loop = times["generate"] - times["encode_images"] - times["prefill"]
        return torch.cat(out).cpu(), steps, loop / steps

    # warm-up of the kernel path's device work; the first 4 head calls of
    # its first batch (beam steps 1-4; step 0 reads the prefill's plain
    # head) are held against the plain head on the hidden states the
    # search gave them
    calls = VocabCalls(4)
    try:
        run(True)
    finally:
        calls.remove()
    check(len(calls.calls) == 4, "{} vocab head calls recorded".format(len(calls.calls)))
    for i, c in enumerate(calls.calls):
        check_vocab_call("vocab path, on the path: bf16 beam step {} of batch 1, R={}".format(
            i + 1, c[0].shape[0]), *c)
    del calls
    vt.launches = 0
    seqs_on, steps_on, ms_on = run(True)
    launches = vt.launches
    check(steps_on > 0 and launches == steps_on,
          "vocab_topk launches {} != {} beam steps".format(launches, steps_on))
    seqs_off, steps_off, ms_off = run(False)
    check(vt.launches == launches, "the plain head launched the vocab kernel")
    check(seqs_on.shape == (len(clips), 40), "sequences shape {}".format(tuple(seqs_on.shape)))
    agree = (seqs_on == seqs_off).all(dim=1).float().mean().item()
    distinct = len({tuple(x) for x in seqs_on.tolist()})
    log("vocab path: {} clips through generate(vocab_kernel=True), vocab_topk launches {} = {} beam "
        "steps; with it off {} steps".format(len(clips), launches, steps_on, steps_off))
    log("vocab path: beam loop ms per step (device events, generate less encode and prefill), one "
        "run each: {:.3f} with the kernel, {:.3f} without; the loop is bound by host launches, "
        "so the device-time profile below is the comparison [{}]".format(ms_on, ms_off, card))
    log("vocab path: bf16 tokens agree on {:.1%} of clips between kernel on and off, with {} "
        "distinct token sequences among the {} clips (printed, not asserted: the two heads sum in "
        "other orders)".format(agree, distinct, len(clips)))
    peak_memory("vocab path (generate, vocab_kernel on and off)", card)

    # device kernel time of one batch with the kernel on and off
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    x = normalized(batches[0], torch.bfloat16)
    groups = (("vocab_topk", ("vocab_topk",)), ("sorts", ("sort",)),
              ("matmuls", ("gemm", "nvjet", "cutlass")))
    totals = {}
    # with --profile a third run: the kernel off and the per-beam top-C by
    # a stable sort of the whole vocab row, as the plain path took it
    # before it went through the blocked top-k (the same tokens)
    from gitax_torch.decode import beam as beam_mod

    blocked = beam_mod._top_k_blocked

    def full_sort(logits, k, block=vt.TILE, bmax=None):
        return beam_mod.top_k_stable(logits, k) if bmax is None else blocked(logits, k, block, bmax)

    runs = [(True, "on"), (False, "off")]
    if PROFILE:
        runs.append((False, "off, full-vocab sort"))
    for vocab_kernel, label in runs:
        model.decode_step_calls = 0
        torch.cuda.synchronize()
        beam_mod._top_k_blocked = full_sort if "sort" in label else blocked
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.generate(x, cls_prefix(x), beam=beam, dtype=torch.bfloat16,
                               fast_prefill=True, decode_kernel=True, vocab_kernel=vocab_kernel)
                torch.cuda.synchronize()
        finally:
            beam_mod._top_k_blocked = blocked
        steps = model.decode_step_calls
        kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
        total = sum(dev_us(e) for e in kernels) / 1e3
        check(total > 0, "the profile shows no device time")
        totals[label] = (total, steps)
        parts = ", ".join("{} {:.2f} ms x{}".format(
            name, sum(dev_us(e) for e in kernels if any(k in e.key.lower() for k in keys)) / 1e3,
            sum(e.count for e in kernels if any(k in e.key.lower() for k in keys)))
            for name, keys in groups)
        log("vocab path profile, one batch of {} clips, kernel {}: device kernel time {:.2f} ms, "
            "{} beam steps; {} [{}]".format(len(batches[0]), label, total, steps, parts, card))
        if vocab_kernel:
            for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
                log("vocab path profile:   {:8.3f} ms {:5.1%} x{:5d}  {}".format(
                    dev_us(e) / 1e3, dev_us(e) / 1e3 / total, e.count, e.key[:90]))
    (t_on, s_on), (t_off, s_off) = totals["on"], totals["off"]
    log("vocab path profile: device kernel time {:.2f} ms on, {:.2f} ms off per batch of {}; "
        "{:.2f} ms saved per batch over {} steps [{}]".format(t_on, t_off, len(batches[0]),
                                                            t_off - t_on, s_on, card))
    return launches


def phase_video_f32_parity(cpu_model, clips, beam):
    """f32 activations, int8 decoder and head, decode kernel on, the
    engine's search settings: 4 clips with the vocab kernel on and off
    give identical tokens."""
    import torch

    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.ops.quant import quantize_git_model_

    model = quantize_git_model_(build_model("cuda", torch.float32, cpu_model))
    x = normalized(clips[:4], torch.float32)
    out, steps = {}, {}
    vt.launches = 0
    calls = VocabCalls(2)
    try:
        for vocab in (True, False):
            model.decode_step_calls = 0
            out[vocab] = model.generate(x, cls_prefix(x), beam=beam, decode_kernel=True,
                                        vocab_kernel=vocab)
            steps[vocab] = model.decode_step_calls
    finally:
        calls.remove()
    check(len(calls.calls) == 2, "{} f32 vocab head calls recorded".format(len(calls.calls)))
    for i, c in enumerate(calls.calls):
        check_vocab_call("video f32 parity, on the path: beam step {}, R={}".format(
            i + 1, c[0].shape[0]), *c)
    check(vt.launches == steps[True], "f32 vocab_topk launches {} != {} steps".format(
        vt.launches, steps[True]))
    (seq_k, lp_k), (seq_p, lp_p) = out[True], out[False]
    check(seq_k.shape == (4, 40) and torch.isfinite(lp_k).all().item(),
          "f32 output shape {} or non-finite logprobs".format(tuple(seq_k.shape)))
    check(torch.equal(seq_k, seq_p), "f32 tokens differ between the vocab kernel and the plain head")
    err = (lp_k - lp_p).abs().max().item()
    check(err <= 1e-4, "f32 logprobs differ by {}".format(err))
    log("video f32 parity: 4 clips, int8 head, decode kernel on: vocab kernel on and off give "
        "identical tokens, logprobs within {:.2e} (tol 1e-4), {} beam steps each, mean length "
        "{:.2f}, {} distinct token sequences".format(
            err, steps[True], (seq_k != 102).sum(1).float().mean().item(),
            len({tuple(x) for x in seq_k.tolist()})))
    del model
    torch.cuda.empty_cache()


def main(argv):
    import torch

    global PROFILE
    check(argv in ([], ["--profile"]), "usage: python3 chip_smoke.py [--profile]")
    PROFILE = bool(argv)
    check(os.path.isdir(os.path.join(ROOT, "gitax_torch")),
          "gitax_torch/ not found beside chip_smoke.py")
    check(torch.cuda.is_available(), "no CUDA device")
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    # 1. device
    card = card_line()
    log("device: {} | torch {} cuda {} | {} device(s)".format(
        card, torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build(card)  # 2
    stats = {"decode_attention": phase_decode_kernel(card),  # 3
             "flash_attention": phase_flash_kernel(card),  # 4
             "vocab_topk": phase_vocab_kernel(card)}  # 9

    # 5, 6: the COCO path
    coco = random_model("GIT_LARGE_COCO", seed=0, gate=12)
    coco_launches, images = phase_coco_slice(card, coco, BertTokenizer(build_tiny_vocab()))
    phase_coco_f32_parity(coco, images)
    del coco

    # 7, 8: the VQA path
    # past the 14-token question prefix: answers of ~2 and ~9 tokens
    vqa = random_model("GIT_LARGE_VQAv2", seed=1, gate=16)
    vqa_d, vqa_f, pairs = phase_vqa_slice(card, vqa, BertTokenizer(build_tiny_vocab(VQA_WORDS)))
    phase_vqa_f32_parity(vqa, pairs)
    del vqa, pairs
    torch.cuda.empty_cache()

    # 10, 11, 12: the video path
    video = video_model(seed=2)
    model, engine, clips, video_d, video_f = phase_video_slice(card, video, BertTokenizer(
        build_tiny_vocab()))
    vocab_launches = phase_vocab_path(card, model, engine, clips)
    beam = engine.beam_for(1)
    del model, engine
    torch.cuda.empty_cache()
    phase_video_f32_parity(video, clips, beam)

    launches = {"decode_attention": coco_launches + vqa_d + video_d,
                "flash_attention": vqa_f + video_f, "vocab_topk": vocab_launches}
    log("main-path launches: decode_attention {} (COCO {} + VQA {} + video {}), flash_attention {} "
        "(VQA {} + video {}), vocab_topk {} (video, vocab_kernel on); all phases {:.1f} s".format(
            launches["decode_attention"], coco_launches, vqa_d, video_d, launches["flash_attention"],
            vqa_f, video_f, vocab_launches, time.perf_counter() - t_start))
    log(card)
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             **stats[name])
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
