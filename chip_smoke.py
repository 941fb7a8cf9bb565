#!/usr/bin/env python3
"""Smoke run of the gitax_torch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device: the card's name and power limit; TF32 off for the parity
     phases;
  2. build: the decode-attention CUDA kernel from gitax_torch/csrc;
  3. kernel against its plain PyTorch version at the main path's shapes
     (GIT_LARGE beam-4, B=32: K=4, H=12, Dh=64, M=257, T=41), f32, bf16
     and int8 memory, and the time per call of both;
  4. the slice: GIT_LARGE_COCO at full width with random EOS-gated
     weights through the port's CaptionEngine (bf16, weight-only int8,
     fast prefill, fast encoder softmax, beam 4) on 3 batches of 32
     random 224x224 images, counting kernel launches;
  5. f32 parity: the same f32 weights decoded through the kernel path
     and the plain path give identical tokens.
Prints one JSON line describing the kernels, then, last, the JSON line
{"ok": true, "device": {...}}.  Imports nothing of JAX and nothing of
the gitax package.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "gitax_torch/csrc/decode_attention.cu"
KERNEL_REPLACES = "gitax/ops/decode_attention.py:147"

# main-path shapes of the decode-attention call (GIT_LARGE_COCO, B=32)
B, K, H, DH, M, T = 32, 4, 12, 64, 257, 41


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


def phase_kernel(card):
    """Kernel against the plain version on the same inputs."""
    import torch

    from gitax_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_reference,
        quantize_memory,
    )

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    kw = dict(beams=K, num_heads=H, head_dim=DH)

    def inputs(dtype, mem_int8, pos, m=M):
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
                    mem_kv=mem, mem_bias=None, mem_scale=scale)

    def upcast(a):
        a = dict(a)
        for key in ("q", "kv_new", "txt_kv"):
            a[key] = a[key].float()
        if a["mem_kv"].dtype != torch.int8:
            a["mem_kv"] = a["mem_kv"].float()
        return a

    worst_main = 0.0
    # the main path's cases; the fourth build variant (f32 with int8
    # memory); one video-length memory (M=1542, the same function's later
    # caller) to show no fixed tile is assumed
    cases = [(name, dtype, mem_int8, M, pos)
             for name, dtype, mem_int8 in (("f32", torch.float32, False),
                                           ("bf16", torch.bfloat16, False),
                                           ("bf16+int8mem", torch.bfloat16, True))
             for pos in (0, 1, 20, 40)]
    cases += [("f32+int8mem", torch.float32, True, M, 20),
              ("bf16 M=1542", torch.bfloat16, False, 1542, 20)]
    for name, dtype, mem_int8, m, pos in cases:
        a = inputs(dtype, mem_int8, pos, m)
        ker_cache, ref_cache = a["txt_kv"].clone(), a["txt_kv"].clone()
        ctx = decode_attention_cuda(**dict(a, txt_kv=ker_cache), **kw)
        ref = decode_attention_reference(**dict(a, txt_kv=ref_cache), **kw)
        torch.cuda.synchronize()
        check(torch.equal(ker_cache, ref_cache), "{} pos={}: cache differs".format(name, pos))
        if dtype == torch.float32:
            # same f32 math, other summation order
            err = (ctx - ref).abs().max().item()
            check(torch.allclose(ctx, ref, atol=1e-5, rtol=1e-5),
                  "{} pos={}: ctx err {}".format(name, pos, err))
            log("kernel {:13s} pos={:2d}: cache bit-equal, max|ctx-plain| {:.3e} "
                "(tol 1e-5 abs + 1e-5 rel)".format(name, pos, err))
            continue
        # bf16: against the plain version run in f32 on the same bf16
        # inputs.  The kernel rounds each probability to bf16 (rel
        # 2^-9), int8 memory is dequantized in bf16 (rel 2^-9), and the
        # context is cast to bf16 once (rel 2^-9): tol 2^-7 of max|v|
        # abs + 2^-7 rel covers them twice over.
        ref32 = decode_attention_reference(**dict(upcast(a), txt_kv=a["txt_kv"].float().clone()), **kw)
        same = (ctx.float() - ref.float()).abs().max().item()
        err = (ctx.float() - ref32).abs().max().item()
        vmax = ref_cache.float().abs().max().item()
        if mem_int8:
            vmax = max(vmax, 127 * a["mem_scale"].max().item())
        else:
            vmax = max(vmax, a["mem_kv"].float().abs().max().item())
        atol = vmax / 128
        check(torch.allclose(ctx.float(), ref32, atol=atol, rtol=1 / 128),
              "{} pos={}: ctx err {} vs f32 plain".format(name, pos, err))
        if name == "bf16":
            worst_main = max(worst_main, err)
        log("kernel {:13s} pos={:2d}: cache bit-equal, max|ctx-plain_f32| {:.3e} "
            "(tol {:.3e} abs + 2^-7 rel), max|ctx-plain_bf16| {:.3e}".format(
                name, pos, err, atol, same))

    # time per call at the main path's bf16 shapes, pos=12 (a caption of
    # ~12 tokens); 6 memory buffers in turn, as the 6 decoder layers read
    # them, so the 150 MB of memory K/V do not sit in the 50 MB L2
    layers = [inputs(torch.bfloat16, False, 12) for _ in range(6)]
    it = {"i": 0}

    def run(fn):
        def call():
            a = layers[it["i"] % 6]
            it["i"] += 1
            fn(**a, **kw)
        return call

    t = [cuda_time_ms(run(decode_attention_reference), 60),
         cuda_time_ms(run(decode_attention_cuda), 300),
         cuda_time_ms(run(decode_attention_cuda), 300),
         cuda_time_ms(run(decode_attention_reference), 60)]
    plain_ms, ker_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    log("kernel time per call, bf16 B={} K={} H={} Dh={} M={} T={} pos=12: "
        "kernel {:.4f} ms, plain {:.4f} ms (plain,kernel,kernel,plain = {}) [{}]".format(
            B, K, H, DH, M, T, ker_ms, plain_ms, ["%.4f" % x for x in t], card))
    mem_bytes = B * H * M * 2 * DH * 2
    log("kernel memory K/V stream {:.1f} MB per call -> {:.0f} GB/s achieved [{}]".format(
        mem_bytes / 1e6, mem_bytes / (ker_ms * 1e-3) / 1e9, card))
    return dict(max_abs_err=worst_main, ms=ker_ms, plain_ms=plain_ms)


def build_model(device, dtype, cpu_model):
    from gitax_torch.models.git import GitModel

    model = GitModel(cpu_model.cfg, device=device, dtype=dtype)
    model.load_state_dict(cpu_model.state_dict())
    return model


def phase_slice(card, cpu_model, tok):
    """GIT_LARGE_COCO through the port's CaptionEngine, as served."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.runtime.engine import CaptionEngine

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

    # device time of each decode step (6 layers + head)
    step_events = []
    orig_step = model.decode_step

    def timed_step(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig_step(*a, **kw)
        e.record()
        step_events.append((s, e))
        return out

    model.decode_step = timed_step
    decode_attention.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    handle = engine.dispatch(images, prefixes)
    captions = engine.resolve(handle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, steps = decode_attention.launches, model.decode_step_calls
    del model.decode_step

    seqs = torch.cat([s.cpu() for s in handle[1]])
    # T_max 41 = [CLS] + max_text_len 40; the [CLS] prefix is stripped
    check(seqs.shape == (96, 40), "sequences shape {}".format(tuple(seqs.shape)))
    lengths = (seqs != engine.beam.eos_id).sum(1).float()
    check(len(captions) == 96 and all(isinstance(c, str) and c for c in captions),
          "empty or missing captions")
    n_layers = model.cfg.num_layers
    check(steps > 0 and launches == n_layers * steps,
          "decode_attention launches {} != {} layers x {} steps".format(launches, n_layers, steps))
    step_ms = sum(s.elapsed_time(e) for s, e in step_events) / len(step_events)
    log("slice: 3 batches x 32 GIT_LARGE_COCO captions, {} beam steps, decode_attention "
        "launches {} = {} x {}".format(steps, launches, n_layers, steps))
    log("slice: {:.2f} images/s, mean decode length {:.2f} tokens, {:.3f} ms per beam "
        "step (device, 6 layers + head) [{}]".format(96 / seconds, lengths.mean().item(),
                                                     step_ms, card))
    log("slice: sample captions: {}".format(captions[:2]))
    del engine, model
    torch.cuda.empty_cache()
    return launches, images


def phase_f32_parity(cpu_model, images):
    """f32 weights: kernel path and plain path, identical tokens.  Uses
    bench.py's search setting (a 24-token buffer whose length norm lets
    is_done stop the loop early), the other side of the engine's rule."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.runtime.engine import CLIP_MEAN, CLIP_STD

    model = build_model("cuda", torch.float32, cpu_model)
    x = torch.from_numpy(np.stack(images[:16])).cuda().float() / 255.0
    x = (x - torch.tensor(CLIP_MEAN, device="cuda")) / torch.tensor(CLIP_STD, device="cuda")
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
    log("f32 parity: 16 images, kernel and plain paths: tokens identical, logprobs within "
        "{:.2e} (tol 1e-4), {} beam steps each (buffer 24), mean length {:.2f}".format(
            err, steps[True], (seq_k != 102).sum(1).float().mean().item()))


def main():
    import torch

    check(os.path.isdir(os.path.join(ROOT, "gitax_torch")),
          "gitax_torch/ not found beside chip_smoke.py")
    check(torch.cuda.is_available(), "no CUDA device")
    from gitax_torch.models.config import get_model_param, config_from_param
    from gitax_torch.models.git import GitModel, eos_gate_
    from gitax_torch.ops import cuda_build
    from gitax_torch.ops.decode_attention import smem_bytes
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    # 1. device
    card = card_line()
    log("device: {} | torch {} cuda {} | {} device(s)".format(
        card, torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib = cuda_build.load("decode_attention")
    log("build: decode_attention in {:.1f} s ({:.1f} s compiling)".format(
        time.perf_counter() - t0, cuda_build.build_seconds("decode_attention")))
    # the wrapper sizes shared memory in Python; the launch sizes it in C
    lib.gitax_decode_attention_smem.restype = ctypes.c_size_t
    for m in (M, 1542):
        c_bytes = lib.gitax_decode_attention_smem(K, DH, m, T)
        check(smem_bytes(K, DH, m, T) == c_bytes,
              "shared memory size: wrapper {} != kernel {}".format(smem_bytes(K, DH, m, T), c_bytes))
    for line in cuda_build.build_log("decode_attention").splitlines():
        if "registers" in line or "spill" in line:
            log("build: " + line.strip())

    # 3. kernel against plain
    kstats = phase_kernel(card)

    # 4. the slice, and 5. f32 parity, on one set of random weights
    cfg = config_from_param(dict(get_model_param("GIT_LARGE_COCO"), fast_softmax=True))
    t0 = time.perf_counter()
    cpu_model = GitModel(cfg).init_params(torch.Generator().manual_seed(0))
    eos_gate_(cpu_model)
    log("weights: GIT_LARGE_COCO random init + EOS gate in {:.1f} s".format(time.perf_counter() - t0))
    tok = BertTokenizer(build_tiny_vocab())
    launches, images = phase_slice(card, cpu_model, tok)
    phase_f32_parity(cpu_model, images)

    log(card)
    log(json.dumps({"kernels": [dict(name="decode_attention", route="cuda", source=KERNEL_SRC,
                                     replaces=KERNEL_REPLACES, launches=launches, **kstats)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
