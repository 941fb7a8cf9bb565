#!/usr/bin/env python3
"""Smoke run of the gitax_torch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py [--profile] [--seed N]

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device: the card's name and power limit; TF32 off for the parity
     phases;
  2. build: the CUDA kernels from gitax_torch/csrc (one nvcc a source,
     in parallel), their compile reports, whether each one's SASS holds
     wgmma (HGMMA) and TMA loads (UTMALDG) (kernels 2 and 3 must), the
     decode kernel's cluster plans at M 1 to 1542, the vocab head's launch
     plan, and the wrappers' shared-memory formulas against the C side's;
  3. decode attention against its plain PyTorch version at the COCO
     path's shapes (GIT_LARGE beam-4, B=32: K=4, H=12, Dh=64, M=257,
     T=41), the VQA path's M=1201, the video's M=1542 and the text
     context's M=245 with its padded mem_bias, f32, bf16 and int8 memory,
     pos 0 to T-1, with and without the memory bias; its time per call
     beside the plain version's and its bound at the four memory lengths;
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
     the first 2 head calls against the plain head, identical tokens;
 13. the decoders the machine offers (PIL, cv2, torchvision.io,
     jpeglib.h and -ljpeg through g++); the TSV loops decode with PIL, as
     gitax does, and the run fails without it; whether PyYAML is there to
     parse the CLI's -p string;
 14. the COCO TSV through the CLI: phase 5's weights written as
     output/GIT_LARGE_COCO/snapshot/model.pt, a 96-row TSV of 224x224 PNG
     payloads through gitax_torch.inference.test_git_inference_single_tsv
     in process, by the -p command line where PyYAML is installed (bf16,
     int8, batch 32): 96 rows, each checked by name (key in order, one
     caption, a string, empty only where the search's tokens are all
     special), decode_attention launches = 6 x beam steps,
     flash_attention none; the checkpoint's write and load seconds, the
     TSV loop's images/s beside phase 5's, one float batch's upload; then
     32 images of one colour plus noise through the same function, with
     the same row checks and the tokens of each empty caption;
 15. the VQA TSV: GIT_LARGE_VQAv2 through run_vqa_tsv with its MinMax
     transform, 32 PNG images at phase 7's four target sizes, two
     questions each of the two lengths: 64 answers in the reference row
     order, flash_attention launched, decode_attention = 6 x steps;
     pairs/s beside phase 7's;
 16. TSV f32 parity: 16 COCO rows through run_caption_tsv give
     generate_batch's captions on the same decoded arrays in the same
     batches, and the decode kernel path's TSV equals the plain path's;
 17. greedy and trie: 8 COCO images through generate(mode='greedy' |
     'trie') with a small class list in bf16 and f32 on phase 5's weights
     with the decoder's attention x5 (shapes, EOS padding, trie outputs
     in the list); the same weights in f64 on the CPU are the witness:
     the card's f32 logits on the CPU's tokens are within the rounding
     bound D of f64's (D = 8 x the CPU f32's own error), and the f32
     tokens equal the
     CPU's up to the first step whose f64 top-2 margin is under 2D
     (`parting_report`); then test_git_inference_single_image on a PNG
     file.
 18. serving: GIT_LARGE_COCO through gitax_torch.serve.build_serving_stack
     (phase 14's checkpoint) and make_http_server on an ephemeral
     localhost port; in f32 (TF32 off) 24 caption and 8 question PNG
     requests at once, each reply equal to generate_batch's for its image
     at the batcher's device batch size; in bf16 + int8 (beam 4, batch
     32, kernel 1 on) after warm(), the same as an agreement share, then
     16 closed-loop clients for 15 s: requests/s, p50 and p99 latency,
     /stats (batch-size histogram, padded slots, errors, rejections), ms
     per beam step with the clients and alone beside phase 5's; 0 errors,
     /stats' count = requests sent, 413 on a body over MAX_BODY_BYTES, 400
     on an undecodable payload;
 19. sampling: GIT_LARGE_COCO bf16 + int8, do_sample (temperature 0.7,
     top-k 50, top-p 0.9, repetition penalty 1.2), num_return_sequences
     2, B=16, a torch.Generator on the card seeded from --seed (default
     0): deterministic per seed, another seed another set, vocab_kernel
     asked for and 0 vocab_topk launches; ms per beam step, distinct
     outputs per input; f32 on 4 images: the card's tokens against the
     CPU port's on one replayed noise table (`gumbel_noise`), a parting
     allowed only at an f64 near-tie (`sampling_parting_report`);
 20. text context: GIT_BASE_COCO at full width (ViT-B/16 at 224 px, M =
     197, D = 768), B=32, beam 4, two ragged contexts of up to 24 tokens
     (M = 245 with a padded tail): kernel path against plain path (f32
     identical, bf16 agreement), f32 card = CPU port on 8 rows,
     flash_attention 0, decode_attention = 6 x steps, counted in the
     kernels line as launches_with_mem_bias (kernel 1 at this shape with
     its mem_bias is checked and timed in phase 3).
 21. training: GIT_LARGE_COCO at full width and depth through
     gitax_torch.train.speed_test_forward_backward (B=32 synthesized
     images, bf16, fast_softmax, AdamW in f32; 2 warm-up + 10 timed
     steps): images/s, ms per step, peak memory, the loss per step
     (finite, falling); the same with remat=True (lower peak, the same
     losses within 2^-7); one step split by CUDA events into encoder
     forward, decoder forward + loss, decoder backward, encoder backward
     and AdamW, with and without fast_softmax, and one step profiled; f32
     card against CPU at GIT_LARGE_COCO's widths with 2 encoder blocks and
     1 decoder layer (loss 1e-5 rel, each gradient 1e-4 relative L2); one
     ScstTrainer.step (B=8, 5 samples, f32); run_finetune over a 64-row
     PNG TSV for 4 steps saving every 2, and a run resumed from step 2
     that ends equal to it; every kernel wrapper raising under autograd.
     No kernel launches.
 22. training on a mesh: the ranks are spawned processes that import
     gitax_torch only, NCCL one card a rank where the machine has a card
     for each, else sharing card 0 over gloo (a rehearsal, which its lines
     say); (a) GIT_LARGE_COCO's widths at 2 encoder blocks and 1 decoder
     layer, f32 (TF32 off), global B=8, ZeRO-1, 3 steps on meshes [2, 1],
     [1, 2] and [2, 2] against the one-card run in this process: the loss
     within 1e-5 relative, the weights within 1e-6 relative L2; (b)
     GIT_LARGE_COCO at full width and depth, bf16 with fast_softmax,
     global B=32, 1 warm-up and 3 timed steps on [2, 1] with ZeRO-1 on
     and off and on [1, 2]: ms a step and each rank's peak memory (ZeRO-1
     must lower it), and with a card a rank the images/s of DP = cards at
     32 rows a rank beside phase 21's; (c) run_finetune on a [2, 1] mesh,
     4 steps saving 2 and 4, and a run resumed from step 2 whose weights,
     moments and step count equal the continuous run's.  No rank launches
     a kernel.
 23. inference on a mesh: this process is rank 0 and ranks 1.. are
     spawned processes that import gitax_torch only, NCCL one card a rank
     where the machine has a card for each, else sharing card 0 over gloo
     (a rehearsal, which its lines say).  First kernels 1-3 at a rank's
     shapes, each against its plain version at phases 3, 4 and 9's bars
     and timed beside its bound, plain version and (kernel 2) SDPA:
     kernel 1 at H=6 (12 heads over 2 model ranks), B=32, M 257 and 1201;
     kernel 2's encoder at H=8, S=1201 and its prefill at H=6,
     M=1201+12; kernel 3 at R=64 (a data rank of 2 at batch 32).  (a)
     f32, GIT_LARGE_COCO's widths at 2 encoder blocks and 1 decoder
     layer, attention x10: 16 COCO images and 8 VQA pairs at S=1201
     (kernel 2 forced on) on [2, 1], [1, 2] and [2, 2] give one card's
     tokens in device batches of a data rank's rows, and every model
     group's ranks hold equal sequences; (b) bf16 + int8 at full size: the
     COCO engine on DP = cards (2 on one card) at 32 rows a data rank,
     images/s beside one card in this call, one batch with
     vocab_kernel=True (kernel 3 at R = 4 x 32 / DP); VQA (30x40, the
     long question) on [1, 2], pairs/s; each rank's peak memory and the
     share of sequences equal to one card's; (c) `python -m
     gitax_torch.inference -p` with mesh_shape 2 on phase 14's TSV and
     checkpoint (every row checked), a 16-row f32 TSV byte-identical to
     the one-card CLI's, and `build_serving_stack(mesh_shape=2)`: f32
     replies equal one card's, /stats counting the mesh's padding, then
     16 closed-loop clients for 10 s beside phase 18.  The launches of
     every rank join the kernels JSON line's.
 24. the doctor: `python -m gitax_torch.doctor --json` in a child process
     exits 0 (CUDA init, a matmul, each kernel built and launched against
     its plain version, the build directory, the TSV round trip); its
     native probe (jpeglib.h / -ljpeg and nvjpeg.h / -lnvjpeg through the
     toolkit's nvcc) on a line of its own;
 25. the w8a8 kernels (csrc/int8_dynamic.cu): quantize_rows' codes and row
     scales and scale_rows' outputs equal their plain versions bit for bit
     and torch._int_mm the exact int32 product, at COCO's (32 x 257) and
     VQA's (32 x 1201) rows, K 1024/4096, N 1024/3072/4096, bf16 and f32;
     the product split at each encoder GEMM (quantize_rows, _int_mm,
     scale_rows) beside its bounds and the bf16 F.linear of the same
     GEMM;
 26. the w8a8 encoder on the path (`quantize_git_model_(encoder=True)`):
     GIT_LARGE_VQAv2 at 30x40 and GIT_LARGE_COCO, B=32, bf16: encode ms
     bf16 against w8a8 (device events), launches = 4 x 24 a batch; COCO's
     sequences against the bf16 weight-only int8 run's (the drift); the
     cut model in f32: the card's w8a8 tokens = the CPU's plain path's;
     in phase 23, the same on [1, 2] (ranks sharing the card over gloo) =
     one card's;
 27. the reference checkpoint: phase 14 writes phase 5's model with
     `ckpt.save_reference_checkpoint`, and the CLI's TSV of the one-colour
     rows from it equals an in-memory engine's with the CLI's settings;
 28. row shards over hosts: in phase 23, (c)'s 16-row f32 TSV on 4 ranks =
     2 hosts x mesh_shape 2, joined by host 0, byte-identical to the
     one-card CLI's;
 29. the trace: `runtime.profiling.trace` around one COCO batch (after
     phase 5) writes a Chrome trace that names kernel 1.
 30. the CLIP towers: RN50 at its published widths (layers (3, 4, 6, 3),
     width 64, heads 32, output 1024, 224 px) and its text tower (width
     512, 8 heads, 12 layers, context 77, vocab 49408), random weights
     from --seed: f32 on the card (TF32 off) within 1e-4 of the largest
     output of the port's CPU plain path on 2 images and 2 token rows
     (grid, pooled, text), the bf16 drift, ms per batch of 32 beside the
     FLOP bound in f32 and bf16 (cuDNN's convolutions: no Pallas kernel);
 31. the CLIP-loaded encoder: a synthesised ViT-L/14 archive (COCO's
     encoder weights, a projection, a tiny text tower) written to the
     work dir and removed, loaded with verify='warn' and resized to 480
     px, then GIT's grid encode of 420x560 inputs (S=1201) in bf16 with
     kernel 2 on: every call on 4 images held to its plain version at
     check_flash_case's bounds, then B=32: 24 launches counted, ms per
     batch beside flash=False, the outputs' relative L2 distance;
 32. sampling on a tensor-parallel model (in phase 23's 2-rank group):
     the cut model in f32 on [1, 2] with phase 19's sampled search (R=2)
     gives one card's tokens with the same seed; GIT_LARGE_COCO bf16 +
     int8 on [1, 2]: ms per beam step sampled and by beam search;
 33. the native loader (g++, libjpeg): whether it built and why not; where
     it built, 16 JPEG rows through the caption TSV with use_native on and
     off.
 34. the device-side search (`decode.device_loop`: one step captured as a
     CUDA graph, launched under a conditional IF node whose predicate the
     card computes; `generate` takes it on one card, eager_loop=True the
     eager loop): first its kernel, `set_condition` (csrc/graph_if.cu),
     against the host's branch and timed; then (a) f32 tokens of the
     graph, its capture and its cached replay, equal to the eager loop's
     on the card at full width (encoders cut to 2 blocks): COCO beam,
     beam with the repetition penalty and num_keep_best 2, greedy, trie,
     VQA at the four grids and both question lengths, video (M = 1542)
     with and without vocab_kernel, text context (mem_bias), and sampling
     (generators of one seed, then one table of draws made outside the
     graph fed to both); (b) kernel 1 replayed in a conditional graph held
     to its plain version at check_decode_case's bounds, and no write
     under a false predicate; on GIT_LARGE_COCO bf16 + int8, B=32: (g) the
     first graph search's capture time and memory against the eager
     loop's peak; (c) ms per beam step, eager and graph in turns, three
     passes each; (d) the device's busy share and the host's launches of
     one batch under torch.profiler; (e) dispatch_device_batch's host ms
     against the batch's device ms, with no synchronising call inside it
     (sync debug mode); (f) the engine's and the TSV loop's images/s and
     the server's requests/s and p99 at 16 clients, eager against graph in
     turns.  From phase 5 on, kernel counts include the replays' launches
     (`settle`: the steps each graph ran on the card times the kernels
     one captured step launches), and ms per beam step is the searches'
     device span less encode and prefill, over the steps.
Phases 14-19, 21, 22, 23, 26-28, 31, 33 and 34 write in build/gitax_torch/smoke_work, removed
after.
Each slice prints its peak device memory.
Prints the card's name and power limit, one JSON line describing the
kernels (launches on the main path; error, time, plain time, bound and
the one-call library time or null), then, last, the JSON line
{"ok": true, "device": {...}}.  Imports nothing of JAX and nothing of
the gitax package.
"""

import collections
import ctypes
import gc
import itertools
import json
import os
import shutil
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
    # no Pallas kernel: the XLA fusions of gitax's w8a8 product
    # (`_int8_dynamic_matmul`, gitax/models/nn.py:53-71)
    "int8_quantize_rows": ("gitax_torch/csrc/int8_dynamic.cu", "gitax/models/nn.py:61"),
    "int8_scale_rows": ("gitax_torch/csrc/int8_dynamic.cu", "gitax/models/nn.py:69"),
    # no Pallas kernel: the condition of gitax's search loop, `cond` of its
    # lax.while_loop, which XLA evaluates on the device
    "graph_if": ("gitax_torch/csrc/graph_if.cu", "gitax/decode/beam.py:283"),
}
# the libraries the kernels live in, one nvcc each
LIBRARIES = list(dict.fromkeys(os.path.splitext(os.path.basename(src))[0]
                               for src, _ in KERNELS.values()))

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
# the text-context path: GIT_BASE_COCO's 197 image tokens (ViT-B/16 at 224
# px) and two contexts of up to 24 tokens (phase 20; kernel 1 with
# mem_bias at this M in phase 3)
CTX_IMAGE, CTX_TOKENS = 197, (24, 24)
CTX_M = CTX_IMAGE + sum(CTX_TOKENS)
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


def device_ms(fn, iters, name, warmup=3, attempts=3):
    """Mean device time of the kernels whose name holds `name` that
    `iters` calls of `fn` launch, from torch.profiler: the kernel's own
    time, which a host clock around calls that launch faster than the host
    can issue them does not give.  The timed calls sit in a marked range
    with one more call before and after it, each side behind a
    synchronize.  A kernel counts if it ran inside the range, or if the
    runtime call that launched it (same correlation id) lies inside the
    range on the host's clock: the device's and the host's clocks are
    aligned only roughly, so a time window alone can miss kernels that
    ran in the range (a run held 61 for 60 calls, others fewer).  The
    tracer does not always keep every kernel record (full runs of this
    script on the H100 held 8 of 20 and 48 of 60, and once none of 20),
    and each record it keeps has the kernel's whole duration, so the mean
    is over the kernels it kept and the count is printed when it is short;
    a profile that keeps fewer than half is taken again, up to `attempts`
    times, and the one that kept most is used."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best, seen = [], []
    for _ in range(attempts):
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
        launched = {e.id for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith("cu") and "Launch" in e.name
                    and lo <= e.time_range.start and e.time_range.end <= hi}
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and name in e.name]
        hit = [e.time_range for e in kernels if e.id in launched
               or lo <= e.time_range.start and e.time_range.end <= hi]
        check(len(hit) <= iters + 2, "the profile shows {} {} kernels inside the range of {} "
              "calls".format(len(hit), name, iters))
        seen.append("{} of {} in the trace".format(len(hit), len(kernels)))
        if len(hit) > len(best):
            best = hit
        if 2 * len(best) >= iters:
            break
    check(best, "the profiles show no {} kernel inside the range of {} calls ({})".format(
        name, iters, "; ".join(seen)))
    if len(best) < iters:
        log("device_ms: the trace kept {} of the {} {} kernels; the mean is over those "
            "(profiles: {})".format(len(best), iters, name, "; ".join(seen)))
    return sum(r.elapsed_us() for r in best) / len(best) / 1e3


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


def settle():
    """Add the launches that replayed search graphs made since the last
    call to the kernels' counts and the models' decode_step_calls
    (`decode.device_loop.settle`: a replay launches a captured step's
    kernels without their wrappers' Python code).  Waits for the card;
    call it before a count is zeroed and before it is read."""
    from gitax_torch.decode import device_loop

    device_loop.settle()


class SearchSpans(object):
    """CUDA events around every `generate`, `encode_images` and `prefill`
    call of a model until `remove`: `loop_ms()` is the searches' device
    span less the encoder's and the prefill's, the loop's part, which
    per beam step is the same measure for the eager loop and the replayed
    graph (a decode step has no span of its own inside a graph)."""

    def __init__(self, model):
        self.spans = {name: DeviceSpans(model, name)
                      for name in ("encode_images", "prefill", "generate")}

    def times(self):
        return {name: s.ms() for name, s in self.spans.items()}

    def loop_ms(self):
        t = self.times()
        return sum(t["generate"]) - sum(t["encode_images"]) - sum(t["prefill"])

    def remove(self):
        for s in self.spans.values():
            s.remove()


def phase_build(card):
    import torch  # the ctypes libraries need the CUDA runtime loaded

    from gitax_torch.ops import cuda_build
    from gitax_torch.ops import decode_attention as da
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops import vocab_topk as vt

    t0 = time.perf_counter()
    cuda_build.build_all(LIBRARIES)
    log("build: {} in parallel in {:.1f} s ({})".format(
        " and ".join(LIBRARIES), time.perf_counter() - t0,
        ", ".join("{} {:.1f} s".format(n, cuda_build.build_seconds(n)) for n in LIBRARIES)))
    for name in LIBRARIES:
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
    for name in LIBRARIES:
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


def decode_inputs(g, dtype, mem_int8, pos, m=M, bias=False, b=B, h=H):
    """One decode-attention call's inputs on the card, N(0, 0.25) values,
    for a batch of b and h heads (default the COCO path's; a rank of a
    model group holds fewer heads).  bias: False (no memory bias), True
    (N(0, 0.25)), or "pad": the text context's bias, 0 over the image and
    each row's valid context tokens and -1e18 over the rest, as `prefill`
    builds it from memory_valid."""
    import torch

    from gitax_torch.ops.decode_attention import quantize_memory

    B, H = b, h  # noqa: N806 -- this call's shapes
    dev = torch.device("cuda")
    r = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    anc = torch.randint(0, K, (B * K, T), generator=g, dtype=torch.int32).to(dev)
    mem = r(B, H, m, 2 * DH)
    scale = None
    if mem_int8:
        mem, scale = quantize_memory(mem)
    else:
        mem = mem.to(dtype)
    mem_bias = r(B, m) if bias is True else None
    if bias == "pad":
        valid = torch.randint(CTX_IMAGE, m + 1, (B, 1), generator=g)
        mem_bias = torch.where(torch.arange(m)[None, :] < valid, 0.0, -1e18).to(dev)
    return dict(q=r(B * K, H * DH).to(dtype), kv_new=r(B * K, H * 2 * DH).to(dtype),
                txt_kv=r(T, B * K, H * 2 * DH).to(dtype), anc=anc,
                pos=torch.full((), pos, dtype=torch.int32, device=dev),
                mem_kv=mem, mem_bias=mem_bias, mem_scale=scale)


def check_decode_case(label, a, dtype, mem_int8, kw, launch=None):
    """One decode-attention call on the inputs `a` against the plain
    version: the cache bit-equal; f32 within 1e-5; bf16 within 2^-7 of
    the plain version in f32 and within max|ctx|/64 of it in bf16.
    launch(**inputs) -> ctx: how the kernel is run (default: the wrapper's
    launch; phase 34 replays it in a graph).  Returns max|ctx - plain|
    (bf16: against the plain version in f32)."""
    import torch

    from gitax_torch.ops.decode_attention import decode_attention_cuda, decode_attention_reference

    def upcast(a):
        a = dict(a)
        for key in ("q", "kv_new", "txt_kv"):
            a[key] = a[key].float()
        if a["mem_kv"].dtype != torch.int8:
            a["mem_kv"] = a["mem_kv"].float()
        return a

    ker_cache, ref_cache = a["txt_kv"].clone(), a["txt_kv"].clone()
    if launch is None:
        ctx = decode_attention_cuda(**dict(a, txt_kv=ker_cache), **kw)
    else:
        ctx = launch(**dict(a, txt_kv=ker_cache))
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
        return err
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
    log("decode kernel {}: cache bit-equal, max|ctx-plain_f32| {:.3e} (tol {:.3e} abs + "
        "2^-7 rel), max|ctx-plain_bf16| {:.3e} (tol {:.3e}, max|ctx|/64)".format(
            label, err, atol, same, same_tol))
    return err


def check_decode_kernel():
    """Decode attention against the plain version on the same inputs at
    the COCO, VQA and video paths' memory lengths; the worst bf16 error
    against the plain version run in f32 at the COCO shape."""
    import torch

    from gitax_torch.ops.decode_attention import cluster_plan

    g = torch.Generator().manual_seed(0)
    kw = dict(beams=K, num_heads=H, head_dim=DH)
    worst_main = 0.0
    kinds = (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
             ("bf16+int8mem", torch.bfloat16, True))
    # the COCO path's cases; the fourth build variant (f32 with int8
    # memory); the VQA path's memory (M=1201) and the video's (M=1542),
    # clusters of 5 and 7 CTAs, at the first and the last text slot; the
    # additive memory bias, random and, at the text context's memory
    # (GIT_BASE_COCO, M = 197 + 2 x 24), as the context path pads it
    cases = [(name, dtype, mem_int8, M, pos, False)
             for name, dtype, mem_int8 in kinds for pos in (0, 1, 20, T - 1)]
    cases += [("f32+int8mem", torch.float32, True, M, 20, False)]
    cases += [(name, dtype, mem_int8, m, pos, False)
              for m in (1201, 1542) for name, dtype, mem_int8 in kinds for pos in (0, T - 1)]
    cases += [(name + "+bias", dtype, mem_int8, m, 12, True)
              for m in (M, 1542) for name, dtype, mem_int8 in kinds]
    cases += [(name + "+pad", dtype, mem_int8, CTX_M, pos, "pad")
              for name, dtype, mem_int8 in kinds for pos in (0, 12, T - 1)]
    for name, dtype, mem_int8, m, pos, bias in cases:
        a = decode_inputs(g, dtype, mem_int8, pos, m, bias)
        label = "{:18s} M={:4d} pos={:2d} (cluster {})".format(
            name, m, pos, cluster_plan(m, K, DH, T, a["mem_kv"].element_size())[0])
        err = check_decode_case(label, a, dtype, mem_int8, kw)
        if name == "bf16" and m == M:
            worst_main = max(worst_main, err)
        del a
    check_decode_pos_range(g, kw)
    torch.cuda.empty_cache()
    return worst_main


def check_decode_pos_range(g, kw):
    """The range check of pos, on the card since pos lives there: a launch
    at pos -1 or T writes nothing (the cache, ctx's buffer) and sets the
    error flag; a launch at pos T-1 after it leaves the flag as it was."""
    import torch

    from gitax_torch.ops.decode_attention import decode_attention_cuda, error_flag

    flag = error_flag("cuda")
    flag.zero_()
    for bad in (-1, T):
        a = decode_inputs(g, torch.bfloat16, False, T - 1)
        a["pos"].fill_(bad)
        cache = a["txt_kv"].clone()
        decode_attention_cuda(**dict(a, txt_kv=cache), **kw)
        torch.cuda.synchronize()
        check(torch.equal(cache, a["txt_kv"]), "decode kernel: pos {} wrote the cache".format(bad))
        check(int(flag[0]) == 1, "decode kernel: pos {} did not set the error flag".format(bad))
        flag.zero_()
    a = decode_inputs(g, torch.bfloat16, False, T - 1)
    decode_attention_cuda(**a, **kw)
    check(int(flag[0]) == 0, "decode kernel: pos {} set the error flag".format(T - 1))
    log("decode kernel: pos -1 and {} launch nothing and set the error flag; pos {} leaves it "
        "clear".format(T, T - 1))


def time_decode(card, g, m, bias=False, b=B, h=H):
    """Kernel 1's time per call in bf16 at pos=12 (a caption of ~12
    tokens) for a batch of b and h heads at memory length m: 6 memory
    buffers in turn, as the 6 decoder layers read them, so the memory K/V
    does not sit in the 50 MB L2 from the call before; the device time,
    the plain version's in turns, the bound."""
    import torch

    from gitax_torch.ops.decode_attention import decode_attention_cuda, decode_attention_reference

    B, H = b, h  # noqa: N806 -- this call's shapes
    kw = dict(beams=K, num_heads=H, head_dim=DH)
    layers = [decode_inputs(g, torch.bfloat16, False, 12, m, bias, b=B, h=H) for _ in range(6)]
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
    # (k|v), q, the new rows read and written into the cache, ctx, the
    # bias; operations: q.k and p.v over [memory ; live text], f32.
    # Under the padded bias only the valid memory rows count (a masked
    # row weighs exp(-1e18) = 0): what this run's data needs
    npos = 12 + 1
    m_live = sum((a["mem_bias"] == 0).sum().item() for a in layers) / (6 * B) if bias else m
    mem_bytes = B * H * m_live * 2 * DH * 2
    nbytes = mem_bytes + B * K * H * npos * 2 * DH * 2 + B * K * H * DH * 2 * 2 \
        + B * K * H * 2 * DH * 2 * 2 + (B * m * 4 if bias else 0)
    bound_ms, bound_by = bound(nbytes, 2 * 2 * B * K * H * (m_live + npos) * DH, F32_FLOPS)
    log("decode kernel time, bf16 B={} K={} H={} Dh={} M={}{} T={} pos=12: kernel {:.4f} ms "
        "on the device (profiler), {:.4f} ms per call back to back (events, host launch "
        "included); plain {:.4f} ms per call (plain,kernel,kernel,plain = {}); bound {:.4f} ms "
        "({}: {:.1f} MB), {:.1%} of it; memory K/V {:.0f} GB/s [{}]".format(
            B, K, H, DH, m, " with mem_bias (text context; {:.1f} valid rows a row on "
            "average)".format(m_live) if bias else "", T, ker_ms,
            call_ms, plain_ms, ["%.4f" % x for x in t], bound_ms,
            bound_by, nbytes / 1e6, bound_ms / ker_ms, mem_bytes / (ker_ms * 1e-3) / 1e9, card))
    del layers
    torch.cuda.empty_cache()
    return dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_decode_kernel(card):
    """Decode attention against the plain version on the same inputs, and
    its time beside the plain version's and its bound at the COCO path's
    M=257, the text context's 245, the VQA path's 1201 and the video's
    1542."""
    import torch

    worst_main = check_decode_kernel()
    g = torch.Generator().manual_seed(0)
    out = {m: time_decode(card, g, m, bias)
           for m, bias in ((M, False), (CTX_M, "pad"), (1201, False), (1542, False))}
    # no single PyTorch call does the ancestry gather, the in-place cache
    # write and one softmax over [memory ; text]
    return dict(max_abs_err=worst_main, **out[M], library_ms=None)


def check_flash_case(g, name, entry, b, h, s, m, dtype, regime, qk_std):
    """One fused-attention call (entry 'qkv': the encoder's, off the fused
    projection; 'masked': the prefill's, GIT's block mask over m memory
    rows) on inputs of q and k std `qk_std` from `g`, against the plain
    version: f32 within 1e-5; bf16 within 2^-7 of the plain version in
    f32 and within max|out|/64 of it in bf16.  Returns max|out - plain|
    (against the plain version in f32)."""
    import torch

    from gitax_torch.ops import flash_attention as fa

    if entry == "qkv":
        scale = torch.tensor([qk_std] * (2 * h * DH) + [0.5] * (h * DH))
        qkv = (torch.randn(b, s, 3 * h * DH, generator=g) * scale).cuda().to(dtype)
        out = fa.flash_qkv_attention(qkv, h).unflatten(2, (h, DH)).transpose(1, 2)
        q, k, v = [x.transpose(1, 2) for x in qkv.unflatten(2, (3, h, DH)).unbind(2)]
    else:
        q, k, v = [(torch.randn(b, s, h * DH, generator=g) * std).cuda().to(dtype)
                   .unflatten(2, (h, DH)).transpose(1, 2) for std in (qk_std, qk_std, 0.5)]
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
        return err
    # against the plain version run in f32 on the same bf16 inputs: the
    # kernel rounds each probability and the context to bf16 once each
    # (rel 2^-8), so 2^-7 of max|v| abs + 2^-7 rel covers them.  That
    # bound is loose where the outputs are small: against the plain
    # version in bf16, which rounds at the same points, the kernel may
    # differ by an ulp of the context or of a probability, within 2^-6 of
    # max|output| (a skipped K tile or a text row that sees the future is
    # off by more)
    ref = fa.attention_reference(q, k, v, m, entry == "masked")
    same = (out.float() - ref.float()).abs().max().item()
    atol = v.float().abs().max().item() / 128
    same_tol = ref32.abs().max().item() / 64
    label = "flash {} {} bf16".format(name, regime)
    check(torch.allclose(out.float(), ref32, atol=atol, rtol=1 / 128),
          "{}: err {} vs f32 plain".format(label, err))
    check(same <= same_tol, "{}: max|out-plain_bf16| {} > max|plain_f32|/64 {}".format(
        label, same, same_tol))
    log("flash kernel bf16 {:20s} {}: max|out-plain_f32| {:.3e} (tol {:.3e} abs + 2^-7 "
        "rel), max|out-plain_bf16| {:.3e} (tol {:.3e}, max|out|/64)".format(
            name, regime, err, atol, same, same_tol))
    return err


def check_flash_kernel():
    """Fused attention against the plain version on the same inputs at the
    VQA and video paths' shapes, f32 and bf16; the worst bf16 error
    against the plain version run in f32 on the VQA shapes."""
    import torch

    g = torch.Generator().manual_seed(1)
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
            err = check_flash_case(g, name, entry, b, h, s, m, dtype, regime, qk_std)
            if dtype == torch.bfloat16 and "video" not in name and regime == "spread":
                worst_main = max(worst_main, err)
    torch.cuda.empty_cache()
    return worst_main


def time_flash(card, g, b, h, s, m=0, masked=False):
    """Kernel 2's time per call in bf16 (the encoder's entry off the fused
    projection, or the prefill's with GIT's block mask over m memory rows)
    at B=b, H=h, S=s: the device time, the plain version's in turns, and
    one PyTorch call of the same function, F.scaled_dot_product_attention
    (a yardstick only: no path calls it; its probabilities are not rounded
    before P.V, and the masked entry hands it GIT's block mask as a
    boolean tensor); the bound: the q.k and p.v products over the columns
    each row sees, against q, k, v read once and o written."""
    import torch
    import torch.nn.functional as F

    from gitax_torch.ops import flash_attention as fa

    if masked:
        q, k, v = [(torch.randn(b, s, h * DH, generator=g) * 0.5).cuda().to(torch.bfloat16)
                   .unflatten(2, (h, DH)).transpose(1, 2) for _ in range(3)]
        idx = torch.arange(s, device="cuda")
        row, col = idx[:, None], idx[None, :]
        allowed = ~((col >= m) & ((row < m) | (col > row)))  # True: attend

        def kernel():
            return fa.fused_attention(q, k, v, m, True)

        def plain():
            return fa.attention_reference(q, k, v, m, True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)

        label, name = "prefill M={} Tp={}".format(m, s - m), "SDPA with the boolean block mask"
        seen = m * m + sum(r + 1 for r in range(m, s))
    else:
        qkv = (torch.randn(b, s, 3 * h * DH, generator=g) * 0.5).cuda().to(torch.bfloat16)
        q, k, v = [x.transpose(1, 2) for x in qkv.unflatten(2, (3, h, DH)).unbind(2)]

        def kernel():
            return fa.flash_qkv_attention(qkv, h)

        def plain():
            return fa.attention_reference(q, k, v)

        def library():
            return F.scaled_dot_product_attention(q, k, v)

        label, name, seen = "encoder", "SDPA", s * s
    plain_ms, _, t = in_turns(plain, kernel, 5, 20, warmup=3)
    ker_ms = device_ms(kernel, 20, "flash_attention")
    # in_turns puts its first argument at the ends: kernel,SDPA,SDPA,kernel
    _, library_ms, t2 = in_turns(kernel, library, 20, 20, warmup=3)
    flops = 4 * b * h * seen * DH
    bound_ms, bound_by = bound(4 * b * h * s * DH * 2, flops, BF16_FLOPS)
    log("flash kernel time, bf16 {} B={} H={} S={} Dh={}: kernel {:.4f} ms on the device "
        "(profiler); plain {:.4f} ms (plain,kernel,kernel,plain = {}); {} {:.4f} ms "
        "(kernel,SDPA,SDPA,kernel = {}); bound {:.4f} ms ({}: {:.1f} GFLOP), {:.1%} of it, "
        "{:.1f} TFLOP/s [{}]".format(
            label, b, h, s, DH, ker_ms, plain_ms, ["%.4f" % x for x in t], name, library_ms,
            ["%.4f" % x for x in t2], bound_ms, bound_by, flops / 1e9, bound_ms / ker_ms,
            flops / 1e9 / ker_ms, card))
    torch.cuda.empty_cache()
    return dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_flash_kernel(card):
    """Fused attention against the plain version on the same inputs, and
    its time beside the plain version's, SDPA's and the fast bf16
    path's."""
    import torch

    from gitax_torch.models.nn import attention_weights, merge_heads, split_heads
    from gitax_torch.ops import flash_attention as fa

    worst_main = check_flash_kernel()
    g = torch.Generator().manual_seed(1)
    # times per call in bf16 at the VQA path's shapes
    enc = time_flash(card, g, B, ENC_H, ENC_S)
    for m, tp in ((PRE_M, PRE_TP), (1542, 1)):
        time_flash(card, g, B, H, m + tp, m, masked=True)

    # the A/B of the S >= 640 gate: the kernel against the encoder's other
    # path, the fast bf16 scores and softmax (nn.self_attention, fast=True),
    # both from the fused projection to the merged context
    for s in (257, 901, ENC_S):
        qkv = (torch.randn(B, s, 3 * ENC_H * DH, generator=g) * 0.5).cuda().to(torch.bfloat16)

        def fast_path():
            q, k, v = (split_heads(x, ENC_H) for x in qkv.chunk(3, dim=-1))
            return merge_heads(torch.matmul(attention_weights(q, k, fast=True).to(v.dtype), v))

        fast_ms, gker, t = in_turns(fast_path, lambda: fa.flash_qkv_attention(qkv, ENC_H), 20, 20,
                                    warmup=3)
        log("gate A/B, bf16 encoder B={} H={} S={}: kernel {:.4f} ms, fast bf16 path {:.4f} ms "
            "(fast,kernel,kernel,fast = {}) [{}]".format(B, ENC_H, s, gker, fast_ms,
                                                         ["%.4f" % x for x in t], card))
    return dict(max_abs_err=worst_main, **enc)


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


def phase_coco_slice(card, cpu_model, tok, trace_dir):
    """GIT_LARGE_COCO through the port's CaptionEngine, as served; then one
    batch under `runtime.profiling.trace` (29), whose trace file must name
    kernel 1."""
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

    spans = SearchSpans(model)
    settle()
    decode_attention.launches = 0
    fa.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    handle = engine.dispatch(images, prefixes)
    captions = engine.resolve(handle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    settle()
    launches, flash_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    loop_ms = spans.loop_ms()
    spans.remove()

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
    step_ms = loop_ms / steps
    log("coco slice: 3 batches x 32 GIT_LARGE_COCO captions, {} beam steps, decode_attention "
        "launches {} = {} x {}, flash_attention launches 0 (S=257)".format(
            steps, launches, n_layers, steps))
    log("coco slice: {:.2f} images/s, mean decode length {:.2f} tokens, {:.3f} ms per beam "
        "step (device events: the searches less encode and prefill, over the steps) "
        "[{}]".format(96 / seconds, lengths.mean().item(), step_ms, card))
    log("coco slice: sample captions: {}".format(captions[:2]))
    peak_memory("coco slice", card)
    from gitax_torch.runtime import profiling

    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        engine.generate_batch(images[:32], prefixes[:32])
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    kernel1 = [e for e in events if e.get("cat") == "kernel"
               and "decode_attention_kernel" in e.get("name", "")]
    check(kernel1, "the trace of one COCO batch names no decode_attention kernel")
    log("trace: runtime.profiling.trace around one COCO batch wrote {} ({:.1f} MiB, {} events, {} "
        "of them decode_attention kernels) in {:.2f} s".format(
            os.path.relpath(path, ROOT), os.path.getsize(path) / 2**20, len(events), len(kernel1),
            time.perf_counter() - t0))
    del engine, model
    torch.cuda.empty_cache()
    return launches, images, 96 / seconds, step_ms


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
        settle()
        model.decode_step_calls = 0
        out[kernel] = model.generate(x, beam=beam, decode_kernel=kernel)
        settle()
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

    spans = SearchSpans(model)
    settle()
    decode_attention.launches = 0
    fa.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    answers, handles = run_vqa(engine, pairs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    settle()
    d_launches, f_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    times, loop_ms = spans.times(), spans.loop_ms()
    spans.remove()

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
            sum(times["prefill"]) / n_pre, loop_ms / steps, lengths.mean().item(), card))
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
    return d_launches, f_launches, pairs, len(pairs) / seconds


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


def vocab_moved(r, act_bytes):
    """Bytes one vocab-head call must move at R=r: the int8 head, the f32
    logits and block statistics, the hidden states, the scales and bias."""
    from gitax_torch.ops import vocab_topk as vt

    nb = (HEAD_V + vt.TILE - 1) // vt.TILE
    return HEAD_W * HEAD_V + r * nb * vt.TILE * 4 + 2 * r * nb * 4 + r * HEAD_W * act_bytes \
        + 2 * HEAD_V * 4


def cycled(fn, copies):
    """A call of fn on the next of `copies` (argument tuples) in turn."""
    it = {"i": 0}

    def call():
        fn(*copies[it["i"] % len(copies)])
        it["i"] += 1
    return call


def time_vocab(card, g, r):
    """Kernel 3's time per call in bf16 at R=r, W=768, V=30522; 4 weight
    copies in turn (94 MB of int8), so that the 23.4 MB matrix is not left
    in the 50 MB L2 from the call before, as in the decode step, where the
    6 layers' weights and memory pass through L2 between two head calls.
    Returns the times and the copies."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    flops = 2 * r * HEAD_W * HEAD_V
    copies = [vocab_inputs(g, r, HEAD_V, HEAD_W, torch.bfloat16) for _ in range(4)]
    kernel = cycled(vt.vocab_logits_topk_cuda, copies)
    plain_ms, call_ms, t = in_turns(cycled(vt.vocab_logits_topk_reference, copies), kernel, 40,
                                    200)
    ker_ms = device_ms(kernel, 60, "vocab_topk")
    # the products run in bf16 on the tensor cores (int8 widened)
    moved = vocab_moved(r, 2)
    bound_ms, bound_by = bound(moved, flops, BF16_FLOPS)
    log("vocab kernel time, bf16 R={} W={} V={}: kernel {:.4f} ms on the device (profiler), "
        "{:.4f} ms per call back to back (events, host launch included); plain {:.4f} ms per call "
        "(plain,kernel,kernel,plain = {}); {:.1f} MB moved (int8 weights + f32 logits + stats) -> "
        "{:.0f} GB/s; bound {:.4f} ms ({}), {:.1%} of it [{}]".format(
            r, HEAD_W, HEAD_V, ker_ms, call_ms, plain_ms, ["%.4f" % x for x in t],
            moved / 1e6, moved / (ker_ms * 1e-3) / 1e9, bound_ms, bound_by, bound_ms / ker_ms,
            card))
    return dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by), copies


def phase_vocab_kernel(card):
    """The fused vocab head against its plain version on the same inputs,
    and the time per call of both."""
    import torch

    from gitax_torch.ops import vocab_topk as vt

    worst_main = check_vocab_kernel()
    g = torch.Generator(device="cuda").manual_seed(3)
    main, copies = time_vocab(card, g, HEAD_R)
    ker_ms = main["ms"]
    kernel = cycled(vt.vocab_logits_topk_cuda, copies)
    flops = 2 * HEAD_R * HEAD_W * HEAD_V
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
    matmul = cycled(torch.matmul, [(c[0], c[1].to(torch.bfloat16)) for c in copies])
    mm_ms = [cuda_time_ms(matmul, 200), cuda_time_ms(matmul, 200)]
    mm_bytes = 2 * HEAD_W * HEAD_V + 2 * HEAD_R * HEAD_V + 2 * HEAD_R * HEAD_W
    log("vocab kernel yardstick, not the function and on no path: torch.matmul of the bf16 hidden "
        "with the head widened to bf16 beforehand {:.4f} and {:.4f} ms per call (events; {:.1f} MB "
        "moved, {:.0f} GB/s; no scale, bias, padding or statistics) beside the kernel's {:.4f} ms "
        "[{}]".format(mm_ms[0], mm_ms[1], mm_bytes / 1e6, mm_bytes / (min(mm_ms) * 1e-3) / 1e9,
                      ker_ms, card))
    del matmul
    # the f32 parity path: plain FMAs outside the tensor cores
    f32_copies = [(c[0].float(),) + c[1:] for c in copies]
    del copies
    f32_ms = device_ms(cycled(vt.vocab_logits_topk_cuda, f32_copies), 20, "vocab_topk")
    f32_plain_ms, _, _ = in_turns(cycled(vt.vocab_logits_topk_reference, f32_copies),
                                  cycled(vt.vocab_logits_topk_cuda, f32_copies), 20, 60)
    f32_bound, f32_by = bound(vocab_moved(HEAD_R, 4), flops, F32_FLOPS)
    log("vocab kernel time, f32 (the parity path) R={} W={} V={}: kernel {:.4f} ms on the device "
        "(profiler); plain {:.4f} ms per call (events, in turns); bound {:.4f} ms ({}: {:.1f} "
        "GFLOP of f32 FMA at 67 TFLOP/s), {:.1%} of it [{}]".format(
            HEAD_R, HEAD_W, HEAD_V, f32_ms, f32_plain_ms, f32_bound, f32_by, flops / 1e9,
            f32_bound / f32_ms, card))
    del f32_copies
    torch.cuda.empty_cache()
    # no single PyTorch call gives the scale, bias, -inf padding and the
    # per-tile max and sum of exponentials
    return dict(max_abs_err=worst_main, **main, library_ms=None)


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

    spans = SearchSpans(model)
    settle()
    decode_attention.launches = 0
    fa.launches = 0
    vt.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    handle = engine.dispatch(clips, prefixes)
    captions = engine.resolve(handle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    settle()
    d_launches, f_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    v_launches = vt.launches
    times, loop_ms = spans.times(), spans.loop_ms()
    spans.remove()

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
        "{:.3f} ms per beam step (device events: the searches less encode and prefill), mean "
        "decode length {:.2f} "
        "tokens [{}]".format(CLIPS / seconds, sum(times["encode_images"]) / n_enc,
                             sum(times["prefill"]) / n_pre, VIDEO_BATCH, loop_ms / steps,
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

    def run(vocab_kernel, eager_loop=False):
        spans = SearchSpans(model)
        settle()
        model.decode_step_calls = 0
        out = []
        for batch in batches:
            x = normalized(batch, torch.bfloat16)
            out.append(model.generate(x, cls_prefix(x), beam=beam, dtype=torch.bfloat16,
                                      fast_prefill=True, decode_kernel=True,
                                      vocab_kernel=vocab_kernel, eager_loop=eager_loop)[0])
        torch.cuda.synchronize()
        loop = spans.loop_ms()
        spans.remove()
        settle()
        steps = model.decode_step_calls
        return torch.cat(out).cpu(), steps, loop / steps

    # warm-up of the kernel path's device work; the first 4 head calls of
    # its first batch (beam steps 1-4; step 0 reads the prefill's plain
    # head), on the eager loop, are held against the plain head on the
    # hidden states the search gave them; then, on the graph path, the
    # warm-up step's call and the captured call, whose clones hold what
    # the last replayed step that ran gave it and computed
    calls = VocabCalls(4)
    try:
        run(True, eager_loop=True)
    finally:
        calls.remove()
    check(len(calls.calls) == 4, "{} vocab head calls recorded".format(len(calls.calls)))
    for i, c in enumerate(calls.calls):
        check_vocab_call("vocab path, on the path: bf16 beam step {} of batch 1, R={}".format(
            i + 1, c[0].shape[0]), *c)
    calls = VocabCalls(2)
    try:
        run(True)
    finally:
        calls.remove()
    check(len(calls.calls) == 2, "{} vocab head calls recorded in the graph's first search".format(
        len(calls.calls)))
    for c, where in zip(calls.calls, ("the warm-up step", "inside the replayed graph, the last "
                                      "step run of batch 2")):
        check_vocab_call("vocab path, on the graph path: {}, R={}".format(where, c[0].shape[0]),
                         *c)
    del calls
    settle()
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
        settle()
        model.decode_step_calls = 0
        torch.cuda.synchronize()
        beam_mod._top_k_blocked = full_sort if "sort" in label else blocked
        try:
            # the eager loop: the same device work as the graph's, and
            # key_averages groups each kernel it launches by name (a
            # graph's kernels land under its launch)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.generate(x, cls_prefix(x), beam=beam, dtype=torch.bfloat16,
                               fast_prefill=True, decode_kernel=True, vocab_kernel=vocab_kernel,
                               eager_loop=True)
                torch.cuda.synchronize()
        finally:
            beam_mod._top_k_blocked = blocked
        settle()
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
    settle()
    vt.launches = 0
    calls = VocabCalls(2)
    try:
        for vocab in (True, False):
            model.decode_step_calls = 0
            out[vocab] = model.generate(x, cls_prefix(x), beam=beam, decode_kernel=True,
                                        vocab_kernel=vocab)
            settle()
            steps[vocab] = model.decode_step_calls
    finally:
        calls.remove()
    # the graph's first search: the warm-up step's head call, then the
    # captured one, whose clones hold the last step that ran
    check(len(calls.calls) == 2, "{} f32 vocab head calls recorded".format(len(calls.calls)))
    for c, where in zip(calls.calls, ("the warm-up step", "inside the replayed graph")):
        check_vocab_call("video f32 parity, on the path: {}, R={}".format(where, c[0].shape[0]),
                         *c)
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


# -- the TSV loops, the CLI, greedy and trie (phases 13-17) -----------------

COCO_TSV_ROWS, VQA_TSV_IMAGES, FLAT_ROWS = 96, 32, 32
TRIE_WORDS = ["hot", "dog", "pot", "red", "fox", "cat", "stand"]
TRIE_CLASSES = ["hot dog", "hot pot", "hot dog stand", "dog", "red fox", "cat"]
# phase 17's weights: the decoder's attention x5 makes greedy's outputs
# depend on the image (5 distinct of 8; 1 at x1) while f32 stays within
# 2.5e-05 of f64 on the CPU; at x10 (phase 16's) scores x100 make f32
# rounding move logits by up to 13% of their scale on either device
SHARPEN_17 = 5
# its rounding bound D, relative to a step's largest |logit|: this many
# times the CPU f32's largest error against f64 in the run; the card's
# f32 errors read 2.2 to 2.6 times the CPU's at x1 to x5
ROUNDING_X = 8


def png_bytes(img):
    """uint8 RGB [H, W, 3] -> PNG bytes, written by PIL (zlib level 1)."""
    import io

    from gitax_torch.io.image import pil_image

    buf = io.BytesIO()
    pil_image().fromarray(img).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def phase_decoders(work):
    """13. Which image decoders the machine offers: PIL, cv2,
    torchvision.io, libjpeg's header and library through g++, and whether
    the native loader built (`use_native=None` takes it where it did,
    else PIL, as gitax does).  PNG rows decode with PIL either way, so the
    run stops here without it."""
    import importlib
    import shutil

    from gitax_torch.io.image import pil_image

    found = []
    for name in ("PIL", "cv2", "torchvision.io"):
        try:
            mod = importlib.import_module(name)
            found.append("{} {}".format(name, getattr(mod, "__version__", "present")))
        except Exception as e:  # noqa: BLE001 - any failure means "not usable here"
            found.append("{} absent ({})".format(name, type(e).__name__))
    gxx = shutil.which("g++")
    if gxx is None:
        found.append("g++ absent")
    else:
        src = "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_decompress_struct c; " \
              "jpeg_create_decompress(&c); return 0; }\n"
        header = subprocess.run([gxx, "-x", "c++", "-fsyntax-only", "-"], input=src, text=True,
                                capture_output=True, timeout=60).returncode == 0
        linked = header and subprocess.run(
            [gxx, "-x", "c++", "-", "-o", os.path.join(work, "jpeg_probe"), "-ljpeg"], input=src,
            text=True, capture_output=True, timeout=60).returncode == 0
        found.append("jpeglib.h with g++: {}, -ljpeg {}".format(
            "found" if header else "not found", "links" if linked else "does not link"))
    try:
        pil_image()
    except ImportError as e:
        check(False, "the TSV loops decode with PIL: {}".format(e))
    from gitax_torch import native

    log("decoders: {}; the TSV loops decode with {}; PyYAML (the -p CLI's parser) {}".format(
        "; ".join(found), "the native loader (use_native=None)" if native.available()
        else "PIL, the native loader not built", "present" if have_yaml() else "absent"))


def have_yaml():
    """Whether PyYAML is importable: `python -m gitax_torch.inference -p`
    parses its string with it."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        return False
    return True


def write_image_tsv(path, images):
    """images -> a base64 PNG image TSV keyed img0, img1, ..."""
    import base64

    from gitax_torch.io.tsv import tsv_writer

    keys = ["img{}".format(i) for i in range(len(images))]
    tsv_writer(([k, base64.b64encode(png_bytes(a))] for k, a in zip(keys, images)), path)
    return keys


class Captured(object):
    """Wraps a module or class attribute (a function or a method) until
    `remove`: records each call's arguments, result and wall seconds."""

    def __init__(self, owner, name):
        self.owner, self.name, self.orig = owner, name, getattr(owner, name)
        self.args, self.results, self.seconds = [], [], []
        orig = self.orig

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            self.args.append(a)
            self.results.append(out)
            return out

        setattr(owner, name, wrapped)

    def remove(self):
        setattr(self.owner, self.name, self.orig)


def check_caption_rows(label, path, keys, decodes):
    """The caption TSV at `path` against its image keys, row by row: one
    row per key, in order, each cell one {"caption": str} equal to the
    detokenised search output.  A caption is empty only where the
    search's tokens are all special ids, which detokenisation skips as
    gitax's does.  `decodes` is the tokenizer's `decode` capture, one call
    per row in row order.  Returns the empty rows as (row, key, ids)."""
    import json

    from gitax_torch.io.tsv import TSVFile

    out = TSVFile(path)
    check(len(out) == len(keys), "{}: {} output rows for {} images".format(label, len(out),
                                                                           len(keys)))
    check(len(decodes.args) == len(keys), "{}: {} detokenisations for {} rows".format(
        label, len(decodes.args), len(keys)))
    special = set(decodes.args[0][0].all_special_ids)
    empty = []
    for i, key in enumerate(keys):
        row = out[i]
        check(row[0] == key, "{}: row {} has key {!r}, not {!r}".format(label, i, row[0], key))
        cell = json.loads(row[1])
        check(isinstance(cell, list) and len(cell) == 1 and isinstance(cell[0], dict)
              and list(cell[0]) == ["caption"] and isinstance(cell[0]["caption"], str),
              "{}: row {} ({}): malformed cell {!r}".format(label, i, key, row[1]))
        ids, text = [int(t) for t in decodes.args[i][1]], decodes.results[i]
        check(cell[0]["caption"] == text, "{}: row {} ({}): caption {!r}, search output {!r}".format(
            label, i, key, cell[0]["caption"], text))
        if not text:
            check(all(t in special for t in ids), "{}: row {} ({}): empty caption from tokens {}, "
                  "not all special".format(label, i, key, ids))
            empty.append((i, key, ids))
    return empty


def phase_coco_tsv(card, cpu_model, images, work, engine_rate):
    """14. The COCO TSV through the CLI: the weights of phase 5 written by
    `ckpt.save_reference_checkpoint` as
    output/GIT_LARGE_COCO/snapshot/model.pt, phase 5's 96 images as a TSV
    of 224x224 PNG payloads, `test_git_inference_single_tsv` in process
    (bf16, int8, batch 32); then 32 images of one colour plus noise
    through the same function."""
    import numpy as np
    import torch

    from gitax_torch import common, inference
    from gitax_torch.ckpt import save_reference_checkpoint
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer

    torch.cuda.reset_peak_memory_stats()
    snap = os.path.join(work, "output", "GIT_LARGE_COCO", "snapshot")
    os.makedirs(snap)
    t0 = time.perf_counter()
    save_reference_checkpoint(os.path.join(snap, "model.pt"), cpu_model)
    write_s = time.perf_counter() - t0
    check(len(images) == COCO_TSV_ROWS, "{} images from phase 5".format(len(images)))
    keys = write_image_tsv(os.path.join(work, "coco.img.tsv"), images)

    build = Captured(inference, "_build_model")
    loop = Captured(CaptionEngine, "run_caption_tsv")
    decodes = Captured(BertTokenizer, "decode")
    # the user's command line, `python -m gitax_torch.inference -p ...`,
    # in process; without PyYAML, which parses -p, the function itself
    argv = ["-p", "{'type': 'test_git_inference_single_tsv', 'image_tsv': 'coco.img.tsv', "
                  "'model_name': 'GIT_LARGE_COCO', 'question_tsv': null, 'out_tsv': "
                  "'coco.out.tsv', 'batch_size': 32, 'dtype': 'bfloat16', 'int8': true}"]
    via = "-p" if have_yaml() else "a direct call (no PyYAML to parse -p)"
    cwd = os.getcwd()
    os.chdir(work)
    settle()
    decode_attention.launches = 0
    fa.launches = 0
    try:
        if via == "-p":
            common.dispatch_main(vars(inference), argv)
        else:
            inference.test_git_inference_single_tsv("coco.img.tsv", "GIT_LARGE_COCO", None,
                                                    "coco.out.tsv", batch_size=32,
                                                    dtype="bfloat16", int8=True)
    finally:
        os.chdir(cwd)
        build.remove()
        loop.remove()
        decodes.remove()
    settle()
    launches, flash_launches = decode_attention.launches, fa.launches
    model = build.results[0]
    steps = model.decode_step_calls

    empty = check_caption_rows("coco tsv", os.path.join(work, "coco.out.tsv"), keys, decodes)
    check(model.textual.output.quantized, "the CLI did not quantise the head")
    check(steps > 0 and launches == model.cfg.num_layers * steps,
          "decode_attention launches {} != {} layers x {} beam steps".format(
              launches, model.cfg.num_layers, steps))
    check(flash_launches == 0, "flash_attention launched {} times at S=257".format(flash_launches))
    rate = COCO_TSV_ROWS / loop.seconds[0]
    log("coco tsv: {} rows of 224x224 PNG through `python -m gitax_torch.inference`'s "
        "test_git_inference_single_tsv by {} (bf16, int8, batch 32): {} rows checked, keys in "
        "order, {} empty captions, {} beam steps, decode_attention launches {} = {} x {}, "
        "flash_attention 0; decoded by PIL".format(COCO_TSV_ROWS, via, COCO_TSV_ROWS, len(empty),
                                                   steps, launches, model.cfg.num_layers, steps))
    log("coco tsv: checkpoint write (save_reference_checkpoint) {:.2f} s ({:.0f} MiB), load onto "
        "the card {:.2f} s; the TSV "
        "loop {:.2f} images/s ({:.2f} s for {} rows, the first batch's warm-up included) beside "
        "the engine's {:.2f} images/s on the same images decoded (phase 5) [{}]".format(
            write_s, os.path.getsize(os.path.join(snap, "model.pt")) / 2**20, build.seconds[0],
            rate, loop.seconds[0], COCO_TSV_ROWS, engine_rate, card))
    # the float upload: the transform's normalised f32 batch, cast to bf16
    # on the host and copied, as dispatch_device_batch does
    batch = np.random.RandomState(0).randn(32, 224, 224, 3).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        torch.from_numpy(batch).to(torch.bfloat16).to("cuda")
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) / 5 * 1e3
    batch_ms = loop.seconds[0] / (COCO_TSV_ROWS / 32) * 1e3
    log("coco tsv: one float batch's upload (32 x 224 x 224 x 3 f32 -> bf16 on the host, 9.2 MiB "
        "copied) {:.2f} ms, {:.1f}% of the loop's {:.1f} ms per batch [{}]".format(
            up_ms, 100 * up_ms / batch_ms, batch_ms, card))
    peak_memory("coco tsv", card)
    del model, build
    torch.cuda.empty_cache()

    # images of one colour plus a little noise, the inputs of an earlier
    # run that stopped here, through the same function
    rng = np.random.RandomState(14)
    flat = [np.clip(rng.randint(0, 256, 3) + rng.randint(-8, 9, (224, 224, 3)), 0, 255)
            .astype(np.uint8) for _ in range(FLAT_ROWS)]
    flat_keys = write_image_tsv(os.path.join(work, "flat.img.tsv"), flat)
    decodes = Captured(BertTokenizer, "decode")
    os.chdir(work)
    try:
        inference.test_git_inference_single_tsv("flat.img.tsv", "GIT_LARGE_COCO", None,
                                                "flat.out.tsv", batch_size=32, dtype="bfloat16",
                                                int8=True)
    finally:
        os.chdir(cwd)
        decodes.remove()
    flat_empty = check_caption_rows("coco tsv, one colour + noise",
                                    os.path.join(work, "flat.out.tsv"), flat_keys, decodes)
    log("coco tsv, one colour + noise: {} rows checked, keys in order, {} distinct captions, {} "
        "empty: {}".format(FLAT_ROWS, len(set(decodes.results)), len(flat_empty), "; ".join(
            "row {} ({}) tokens {}".format(i, k, ids[:6]) for i, k, ids in flat_empty[:8])))
    torch.cuda.empty_cache()
    return launches, rate, write_s


def phase_vqa_tsv(card, cpu_model, tok, work, engine_rate):
    """15. GIT_LARGE_VQAv2 through `run_vqa_tsv` with its MinMax transform:
    32 PNG images, 8 at each of phase 7's four MinMax target sizes, two
    questions each of the two lengths."""
    import json

    import numpy as np
    import torch

    from gitax_torch.common import json_dump
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.io.tsv import TSVFile, tsv_writer
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.preprocess.transforms import TestTransform, min_max_resize_size
    from gitax_torch.runtime.engine import CaptionEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model("cuda", torch.bfloat16, cpu_model)
    crop, ratio_max = 420, 560
    engine = CaptionEngine(model, tok, batch_size=32, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                           dtype=torch.bfloat16, int8=True, fast_prefill=True, decode_kernel=True,
                           transform=TestTransform(crop_size=crop, respect_ratio_max=ratio_max))
    rng = np.random.RandomState(15)
    images = []
    for i in range(VQA_TSV_IMAGES):
        h, w = min_max_resize_size(VQA_SOURCES[i % 4][0], crop, ratio_max)
        check(min_max_resize_size((w, h), crop, ratio_max) == (h, w), "not its own target")
        images.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    img_tsv, q_tsv = os.path.join(work, "vqa.img.tsv"), os.path.join(work, "vqa.q.tsv")
    keys = write_image_tsv(img_tsv, images)
    tsv_writer(([k, json_dump([{"question": VQA_QUESTIONS[j], "question_id": 2 * i + j}
                               for j in (0, 1)])] for i, k in enumerate(keys)), q_tsv)

    settle()
    decode_attention.launches = 0
    fa.launches = 0
    model.decode_step_calls = 0
    t0 = time.perf_counter()
    with engine:
        engine.run_vqa_tsv(img_tsv, q_tsv, os.path.join(work, "vqa.out.tsv"))
    seconds = time.perf_counter() - t0
    settle()
    d_launches, f_launches, steps = decode_attention.launches, fa.launches, model.decode_step_calls
    rows = [json.loads(r[0]) for r in TSVFile(os.path.join(work, "vqa.out.tsv"))]
    n = 2 * VQA_TSV_IMAGES
    check([r["question_id"] for r in rows] == list(range(n)),
          "answers not in the reference row order, or a question_id twice or missing")
    check(all(isinstance(r["answer"], str) for r in rows), "a malformed answer")
    check(f_launches > 0, "flash_attention never launched at S 881-1201")
    check(steps > 0 and d_launches == model.cfg.num_layers * steps,
          "decode_attention launches {} != {} layers x {} beam steps".format(
              d_launches, model.cfg.num_layers, steps))
    log("vqa tsv: {} PNG images at grids 30x30, 22x40, 30x40, 40x30 through run_vqa_tsv (MinMax "
        "420/560, bf16, int8): {} answers in the reference row order, {} beam steps; "
        "flash_attention launches {}, decode_attention launches {} = {} x {}".format(
            VQA_TSV_IMAGES, len(rows), steps, f_launches, d_launches, model.cfg.num_layers, steps))
    log("vqa tsv: {:.2f} pairs/s through the TSV loop ({:.2f} s, decode and warm-up included) beside "
        "the engine's {:.2f} pairs/s on decoded arrays (phase 7) [{}]".format(
            n / seconds, seconds, engine_rate, card))
    peak_memory("vqa tsv", card)
    del engine, model
    torch.cuda.empty_cache()
    return d_launches, f_launches, n / seconds


def sharpen_(model, attention=10, projection=10):
    """The CPU tests' sharpening, in place: the visual projection's weight
    and the decoder's attention weights (q, k, v, out) scaled, so that
    outputs depend on the image (the random weights give most images one
    caption)."""
    import torch

    with torch.no_grad():
        model.textual.visual_projection[0].weight.mul_(projection)
        for layer in model.textual.layers():
            for lin in (layer.attention.qkv.query, layer.attention.qkv.key,
                        layer.attention.qkv.value, layer.attention.output.dense):
                lin.weight.mul_(attention)
    return model


def phase_tsv_f32_parity(cpu_model, work):
    """16. 16 COCO rows at f32: run_caption_tsv's captions equal
    generate_batch's on the same decoded arrays in the same batches, and
    the decode kernel path's TSV equals the plain path's, byte for byte,
    on phase 5's weights with sharper attention over the image."""
    import json

    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.io.tsv import TSVFile, tsv_writer
    from gitax_torch.preprocess.transforms import TestTransform
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    src = TSVFile(os.path.join(work, "coco.img.tsv"))
    img_tsv = os.path.join(work, "parity.img.tsv")
    tsv_writer((src[i] for i in range(16)), img_tsv)
    model = sharpen_(build_model("cuda", torch.float32, cpu_model))
    tok = BertTokenizer(build_tiny_vocab())
    out, caps = {}, {}
    for kernel in (True, False):
        engine = CaptionEngine(model, tok, batch_size=8,
                               beam=BeamSearchConfig(num_beams=4, max_steps=40),
                               dtype=torch.float32, decode_kernel=kernel,
                               transform=TestTransform(crop_size=224))
        path = os.path.join(work, "parity.{}.tsv".format(kernel))
        with engine:
            engine.run_caption_tsv(img_tsv, path)
            if kernel:
                arrays = [engine._decode_row(src[i][1]) for i in range(16)]
                direct = engine.generate_batch(arrays, [[tok.cls_token_id]] * 16)
        with open(path, "rb") as fp:
            out[kernel] = fp.read()
        caps[kernel] = [json.loads(r[1])[0]["caption"] for r in TSVFile(path)]
    check(caps[True] == direct, "run_caption_tsv's captions differ from generate_batch's")
    check(out[True] == out[False], "the decode kernel path's TSV differs from the plain path's")
    log("tsv f32 parity: 16 COCO rows, batches of 8: run_caption_tsv = generate_batch on the "
        "same decoded arrays; decode kernel path TSV = plain path TSV ({} bytes); {} distinct "
        "captions".format(len(out[True]), len(set(caps[True]))))
    del model
    torch.cuda.empty_cache()


def forced_logits(model, memory, seqs, dtype):
    """Logits [B, S - 1, V] of greedy's steps on `model`, on the CPU, in
    the model's accumulation type (f32, or f64 for f64), from its memory
    (`build_memory`), when the tokens fed are seqs [B, S] ([CLS], then
    the generated ones): step s predicts seqs[:, s + 1].  The prefill
    and plain decode step of generate(mode='greedy' | 'trie') with
    max_steps S."""
    import torch

    visual, valid = memory
    with torch.inference_mode():
        seqs = seqs.to(visual.device)
        logits, cache = model.prefill(visual, seqs[:, :1], seqs.shape[1], valid, dtype)
        out = [logits.cpu()]
        for s in range(1, seqs.shape[1] - 1):
            logits, cache = model.decode_step(seqs[:, s], cache, dtype)
            out.append(logits.cpu())
    return torch.stack(out, 1)


def parting_report(label, card_seqs, cpu_seqs, logits, allowed=None, eos=102):
    """Where the f32 tokens of one search on the card and on the CPU
    part, held to the f64 witness.  logits["card" | "cpu" | "f64"] are
    `forced_logits` on the CPU's tokens, so up to a row's first differing
    step they are the logits each search read.  The rounding bound D of a
    step is ROUNDING_X times the CPU f32's largest error against f64 in
    this run, relative to the step's largest |logit|, times that |logit|.
    Checks, per row, up to its first parting (or the CPU's EOS): the
    card's f32 logits are within D of f64's; and the tokens agree up to
    the first step whose f64 top-2 margin is under 2D, where rounding of D
    can swap the top two.  allowed(row, step) gives a step's candidate
    tokens (a trie node's children) or None (the whole vocabulary).
    Returns the partings, the CPU's and the card's largest relative
    errors."""
    import torch

    lg = {k: v.double() for k, v in logits.items()}
    rows = []
    for b in range(cpu_seqs.shape[0]):
        cpu_row, card_row = cpu_seqs[b].tolist(), card_seqs[b].tolist()
        end = cpu_row.index(eos, 1) if eos in cpu_row[1:] else len(cpu_row) - 1
        steps = []
        for s in range(end):
            cand = allowed(b, s) if allowed else None
            step = {k: (v[b, s] if cand is None else v[b, s, cand]) for k, v in lg.items()}
            scale = lg["f64"][b, s].abs().max().item()  # over the whole vocabulary
            err = {k: (step[k] - step["f64"]).abs().max().item() / scale for k in ("card", "cpu")}
            top = torch.topk(step["f64"], 2) if step["f64"].numel() > 1 else None
            steps.append(dict(
                scale=scale, err=err, margin=(top.values[0] - top.values[1]).item() / scale
                if top is not None else float("inf"),
                f64=(cand[top.indices[0]].item() if cand is not None else top.indices[0].item())
                if top is not None else None))
        differ = [s for s in range(end) if card_row[s + 1] != cpu_row[s + 1]]
        rows.append((b, cpu_row, card_row, steps, differ[0] if differ else None))
    rel_cpu = max([max(st["err"]["cpu"] for st in steps) for *_, steps, _ in rows if steps]
                  + [2.0 ** -23])
    rel_d = ROUNDING_X * rel_cpu
    partings, rel_card = [], 0.0
    for b, cpu_row, card_row, steps, first in rows:
        for s, st in enumerate(steps[:first + 1 if first is not None else len(steps)]):
            rel_card = max(rel_card, st["err"]["card"])
            check(st["err"]["card"] <= rel_d, "{}: row {} step {}: the card's f32 logits are "
                  "{:.3e} of the step's largest |logit| from f64's, over D = {:.3e}".format(
                      label, b, s, st["err"]["card"], rel_d))
        tie = next((s for s, st in enumerate(steps) if st["margin"] < 2 * rel_d), None)
        if first is not None:
            st = steps[first]
            check(tie is not None and first >= tie, "{}: row {} parts at step {}, before the first "
                  "step ({}) whose f64 top-2 margin is under 2D: margin {:.3e}, 2D {:.3e} (of the "
                  "step's largest |logit|)".format(label, b, first, tie, st["margin"], 2 * rel_d))
            partings.append("row {} step {}: f64 top-2 margin {:.2e}, card error {:.2e}, CPU "
                            "error {:.2e}, 2D {:.2e}; tokens card {} CPU {} f64 {}".format(
                                b, first, st["margin"], st["err"]["card"], st["err"]["cpu"],
                                2 * rel_d, card_row[first + 1], cpu_row[first + 1], st["f64"]))
    return partings, rel_cpu, rel_card


def phase_greedy_trie(card, cpu_model, work):
    """17. Greedy and trie on the card: 8 COCO images through
    generate(mode='greedy' | 'trie') in bf16 and f32, on phase 5's weights
    with the attention x SHARPEN_17, so that outputs depend on the image; the
    f32 tokens against the same weights' on the CPU, both held to the
    same weights in f64 (`parting_report`); then one
    test_git_inference_single_image call on a PNG file, from the
    checkpoint of phase 14."""
    import base64
    import copy

    import numpy as np
    import torch

    from gitax_torch import inference
    from gitax_torch.decode.trie import build_vocab_trie
    from gitax_torch.io.image import load_image
    from gitax_torch.io.tsv import TSVFile
    from gitax_torch.models.git import GitModel
    from gitax_torch.preprocess.transforms import TestTransform
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    torch.cuda.reset_peak_memory_stats()
    src = TSVFile(os.path.join(work, "coco.img.tsv"))
    tf = TestTransform(crop_size=224)
    x = torch.from_numpy(np.stack([tf(load_image(base64.b64decode(src[i][1])))
                                   for i in range(8)]))
    tok = BertTokenizer(build_tiny_vocab(TRIE_WORDS))
    trie = build_vocab_trie(tok, TRIE_CLASSES)
    eos = 102
    sharp = sharpen_(copy.deepcopy(cpu_model), attention=SHARPEN_17, projection=1)
    results, logits = {}, {"greedy": {}, "trie": {}}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model("cuda", dtype, sharp)
        for mode in ("greedy", "trie"):
            t0 = time.perf_counter()
            seqs, lp = model.generate(x.cuda(), mode=mode, trie=trie, dtype=dtype)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            seqs, lp = seqs.cpu(), lp.float().cpu()
            check(seqs.shape == (8, 40) and lp.shape == (8,) and torch.isfinite(lp).all().item(),
                  "{} {}: shapes {} {} or non-finite logprobs".format(mode, dtype, tuple(seqs.shape),
                                                                       tuple(lp.shape)))
            for row in seqs.tolist():
                first = row.index(eos) if eos in row else len(row)
                check(all(t == eos for t in row[first:]), "{} {}: not EOS-padded".format(mode, dtype))
            if mode == "trie":
                names = [tok.decode(r[1:], skip_special_tokens=True) for r in seqs.tolist()]
                check(all(n in TRIE_CLASSES for n in names),
                      "trie {}: outputs outside the class list: {}".format(dtype, names))
            results[(mode, dtype)] = seqs
            log("greedy/trie: {} {}: 8 images in {:.2f} s, mean length {:.2f}, {} distinct "
                "outputs{} [{}]".format(
                    mode, str(dtype)[6:], seconds, (seqs != eos).sum(1).float().mean().item(),
                    len({tuple(r) for r in seqs.tolist()}),
                    ", classes {}".format(sorted(set(names))) if mode == "trie" else "", card))
        if dtype == torch.float32:
            cpu_seqs = {mode: sharp.generate(x, mode=mode, trie=trie)[0]
                        for mode in ("greedy", "trie")}
            with torch.inference_mode():
                memory = model.build_memory(x.cuda(), dtype=dtype)
            for mode in ("greedy", "trie"):
                logits[mode]["card"] = forced_logits(model, memory, cpu_seqs[mode], dtype)
            del memory
        del model
        torch.cuda.empty_cache()

    # the witness: the same weights in f64 on the CPU, on the CPU's tokens
    t0 = time.perf_counter()
    m64 = GitModel(sharp.cfg, device="cpu", dtype=torch.float64)
    m64.load_state_dict(sharp.state_dict())
    for name, model, dtype in (("cpu", sharp, torch.float32), ("f64", m64, torch.float64)):
        with torch.inference_mode():
            memory = model.build_memory(x.to(dtype), dtype=dtype)
        for mode in ("greedy", "trie"):
            logits[mode][name] = forced_logits(model, memory, cpu_seqs[mode], dtype)
    del m64, sharp, memory
    witness_s = time.perf_counter() - t0

    def trie_children(b, s):
        """The trie's candidates at step s of row b of the CPU's search:
        the children of its node, less the token just emitted (blocked)."""
        row = cpu_seqs["trie"][b].tolist()
        kids = [t for t in trie.get_valid(row[1:s + 1]) if s == 0 or t != row[s]]
        return torch.tensor(kids, dtype=torch.long)

    for mode in ("greedy", "trie"):
        card_seqs = results[(mode, torch.float32)]
        partings, rel_cpu, rel_card = parting_report(
            "{} f32".format(mode), card_seqs, cpu_seqs[mode], logits[mode],
            allowed=trie_children if mode == "trie" else None)
        agree = int((card_seqs == cpu_seqs[mode]).all(1).sum())
        log("greedy/trie: {} f32 on the attention x{} weights, card against CPU: {} of 8 rows equal, "
            "{} distinct outputs on the card, {} on the CPU; f32 logits against the f64 witness "
            "(relative to the step's largest |logit|): CPU within {:.3e}, card within {:.3e}, D = "
            "{} x the CPU's; partings: {}".format(
                mode, SHARPEN_17, agree, len({tuple(r) for r in card_seqs.tolist()}),
                len({tuple(r) for r in cpu_seqs[mode].tolist()}), rel_cpu, rel_card, ROUNDING_X,
                "; ".join(partings) or "none"))
    log("greedy/trie: the CPU's f32 and f64 runs on the CPU's tokens took {:.1f} s".format(
        witness_s))
    peak_memory("greedy/trie", card)

    path = os.path.join(work, "single.png")
    with open(path, "wb") as fp:
        fp.write(base64.b64decode(src[0][1]))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        cap = inference.test_git_inference_single_image(path, "GIT_LARGE_COCO", "")
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check(isinstance(cap, str) and cap, "test_git_inference_single_image gave {!r}".format(cap))
    log("single image: test_git_inference_single_image on a 224x224 PNG from the checkpoint "
        "(f32, beam 4, 1024-token buffer): {!r} in {:.2f} s, the load included [{}]".format(
            cap, seconds, card))
    torch.cuda.empty_cache()


# -- serving, sampling and text context (phases 18-20) ----------------------

SERVE_CAPTIONS, SERVE_QUESTIONS = 24, 8
SERVE_QUESTION = "what is in the picture?"
LOAD_CLIENTS, LOAD_SECONDS = 16, 15.0
SAMPLE_B, SAMPLE_R, SAMPLE_F32_B = 16, 2, 4


def http_post(base, body, timeout=600):
    """POST raw bytes to /v1/caption: (status, parsed JSON reply)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/v1/caption", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def http_get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


class Served(object):
    """`serve.make_http_server` on an ephemeral localhost port, served by a
    thread until the block ends; the root logger is held at WARNING
    meanwhile (the CLI of phase 14 left it printing INFO, and the server
    logs every request)."""

    def __init__(self, batcher):
        import logging
        import threading

        from gitax_torch import serve

        self.httpd = serve.make_http_server(batcher, "GIT_LARGE_COCO", host="127.0.0.1", port=0)
        self.port = self.httpd.server_address[1]
        self.base = "http://127.0.0.1:{}".format(self.port)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.root, self.level = logging.getLogger(), logging.getLogger().level

    def __enter__(self):
        import logging

        self.root.setLevel(logging.WARNING)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        self.root.setLevel(self.level)
        check(not self.thread.is_alive(), "the HTTP server thread did not stop")


def serving_stack(work, dtype, int8):
    """`gitax_torch.serve.build_serving_stack` for GIT_LARGE_COCO, from the
    checkpoint phase 14 wrote into `work` (the model loads from the
    working directory's output/, as the CLI's does)."""
    from gitax_torch import serve

    cwd = os.getcwd()
    os.chdir(work)
    try:
        return serve.build_serving_stack("GIT_LARGE_COCO", batch_size=32, dtype=dtype,
                                         int8=int8)
    finally:
        os.chdir(cwd)


def concurrent_requests(base, bodies):
    """POST every body at once, one thread each; the replies in order."""
    import threading

    replies = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def send(i):
        start.wait()
        try:
            replies[i] = http_post(base, bodies[i])
        except OSError as e:  # a refused or reset connection fails the check below
            replies[i] = (None, {"error": repr(e)})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a request thread did not finish")
    return replies


def closed_loop(base, bodies, seconds):
    """LOAD_CLIENTS closed-loop clients, each sending its next body when
    its reply comes, for `seconds`: (latencies s, non-200 codes, requests
    sent, wall seconds)."""
    import threading

    lat, bad, sent = [], [], [0]
    lock = threading.Lock()
    stop_at = time.perf_counter() + seconds

    def client(ci):
        i = ci
        while time.perf_counter() < stop_at:
            t = time.perf_counter()
            try:
                code, _ = http_post(base, bodies[i % len(bodies)])
            except OSError as e:
                code = repr(e)
            with lock:
                sent[0] += 1
                lat.append(time.perf_counter() - t)
                if code != 200:
                    bad.append(code)
            i += LOAD_CLIENTS

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(LOAD_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    load_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a load client did not finish")
    return lat, bad, sent[0], load_s


def served_against_direct(label, engine, batcher, base, payloads, questions):
    """Send every (payload, question) at once through the endpoint; hold
    each reply to `engine.generate_batch` of the same rows at the device
    batch size the batcher used, matched by image.  The batches are read
    from the engine's `dispatch_device_batch` calls; a row that repeats one
    already in its batch is the batcher's padding.  Returns (replies,
    references, the dispatched batches' sizes, the disagreeing images)."""
    import numpy as np

    from gitax_torch.io.image import image_from_base64

    arrays = [np.asarray(engine.transform(image_from_base64(p)), np.float32) for p in payloads]
    prefixes = [engine.encode_prefix(q) for q in questions]
    bodies = [json.dumps(dict(image=p, **({"question": q} if q else {}))).encode()
              for p, q in zip(payloads, questions)]
    calls = Captured(engine, "dispatch_device_batch")
    try:
        replies = concurrent_requests(base, bodies)
    finally:
        calls.remove()
        del engine.dispatch_device_batch  # the instance attribute remove() left
    check(all(code == 200 for code, _ in replies), "{}: replies {}".format(
        label, [r for r in replies if r[0] != 200][:3]))
    refs, sizes = {}, []
    for imgs, pref in calls.args:
        idxs = []
        for row, p in zip(imgs, pref):
            hit = [i for i in range(len(arrays))
                   if i not in idxs and prefixes[i] == list(p) and np.array_equal(arrays[i], row)]
            if hit:
                idxs.append(hit[0])
        sizes.append((len(idxs), len(imgs)))
        saved = engine.batch_size
        engine.batch_size = len(imgs)
        try:
            out = engine.generate_batch([arrays[i] for i in idxs], [prefixes[i] for i in idxs])
        finally:
            engine.batch_size = saved
        refs.update(zip(idxs, out))
    check(sorted(refs) == list(range(len(payloads))), "{}: {} of {} images found in the "
          "dispatched batches".format(label, len(refs), len(payloads)))
    got = [body["caption"] for _, body in replies]
    differ = [i for i in range(len(payloads)) if got[i] != refs[i]]
    return got, [refs[i] for i in range(len(payloads))], sizes, differ


def phase_serving(card, cpu_model, images, work, coco_step_ms):
    """18. Serving: GIT_LARGE_COCO through `build_serving_stack` (from phase
    14's checkpoint) and `make_http_server` on an ephemeral localhost port.
    f32 (int8 off, TF32 off): 24 caption and 8 question requests at once,
    each reply equal to generate_batch's at the batcher's device batch
    size.  bf16 + int8 (the served setting, beam 4, batch 32, kernel 1 on)
    after warm(): the same, as an agreement share; 16 closed-loop clients
    for LOAD_SECONDS; 413 and 400.  Returns the decode_attention launches
    of the served runs."""
    import base64
    import http.client

    import numpy as np
    import torch

    from gitax_torch.io.image import image_from_base64
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.serve import MAX_BODY_BYTES

    torch.cuda.reset_peak_memory_stats()
    n = SERVE_CAPTIONS + SERVE_QUESTIONS
    payloads = [base64.b64encode(png_bytes(a)).decode() for a in images[:n]]
    questions = [""] * SERVE_CAPTIONS + [SERVE_QUESTION] * SERVE_QUESTIONS
    launches = steps = 0

    # f32: equality required.  The attention x SHARPEN_17 (phase 17's) so
    # that replies depend on the image and a reply matched to the wrong
    # image would show; served and direct paths run the same model
    engine, batcher = serving_stack(work, "float32", int8=False)
    sharpen_(engine.model, attention=SHARPEN_17, projection=1)
    try:
        with Served(batcher) as srv:
            settle()
            decode_attention.launches = fa.launches = engine.model.decode_step_calls = 0
            got, refs, sizes, differ = served_against_direct(
                "serving f32", engine, batcher, srv.base, payloads, questions)
            settle()
            launches += decode_attention.launches
            steps += engine.model.decode_step_calls
            check(fa.launches == 0, "flash_attention launched at S=257")
        snap = batcher.snapshot()
    finally:
        batcher.close()
        engine.close()
    # the two paths run the same code on the same rows at one batch shape,
    # so no rounding can part them: any difference fails
    for i in differ:
        log("serving f32: image {} ({}): served {!r}, generate_batch {!r}".format(
            i, "question" if questions[i] else "caption", got[i], refs[i]))
    check(not differ, "serving f32: {} of {} replies differ from generate_batch at the same "
          "device batch size".format(len(differ), n))
    log("serving f32 (attention x{}): {} requests at once ({} captions, {} questions) through the "
        "endpoint: every reply equals generate_batch's for its image at the batcher's device batch "
        "size; "
        "dispatches (real, device rows) {}; {} distinct replies; stats {}".format(
            SHARPEN_17, n, SERVE_CAPTIONS, SERVE_QUESTIONS, sizes, len(set(got)),
            {k: snap[k] for k in ("requests", "batches", "padded_slots", "errors")}))
    del engine, batcher
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 + int8, as served
    engine, batcher = serving_stack(work, "bfloat16", int8=True)
    model = engine.model
    try:
        t0 = time.perf_counter()
        batcher.warm(prefix_lens=(1, len(engine.encode_prefix(SERVE_QUESTION))))
        warm_s = time.perf_counter() - t0
        # ms per beam step without clients: one batch through the engine at
        # the load's usual bucket (16) and at phase 5's 32
        arrays = [np.asarray(engine.transform(image_from_base64(p)), np.float32)
                  for p in payloads]
        alone = {}
        for bs in (16, 32):
            spans = SearchSpans(model)
            settle()
            model.decode_step_calls = 0
            engine.batch_size = bs
            t0 = time.perf_counter()
            try:
                engine.generate_batch(arrays[:bs], [[101]] * bs)
                torch.cuda.synchronize()
            finally:
                engine.batch_size = 32
            wall = time.perf_counter() - t0
            settle()
            alone[bs] = (spans.loop_ms() / model.decode_step_calls,
                         wall / model.decode_step_calls * 1e3)
            spans.remove()
        with Served(batcher) as srv:
            check(http_get(srv.base, "/healthz") == (200, {"ok": True, "model": "GIT_LARGE_COCO"}),
                  "/healthz")
            settle()
            decode_attention.launches = fa.launches = model.decode_step_calls = 0
            got, refs, sizes, differ = served_against_direct(
                "serving bf16", engine, batcher, srv.base, payloads, questions)
            agree = 1 - len(differ) / n

            # load: closed-loop clients, each sending its next request when
            # its reply comes
            settle()
            spans = SearchSpans(model)
            # per bucket: the dispatches' host milliseconds (the upload and
            # the search enqueued; the search itself runs after)
            per_bucket = collections.defaultdict(list)
            dispatch = engine.dispatch_device_batch

            def timed(imgs, pref):
                t = time.perf_counter()
                out = dispatch(imgs, pref)
                per_bucket[len(imgs)].append((time.perf_counter() - t) * 1e3)
                return out

            engine.dispatch_device_batch = timed
            steps0 = model.decode_step_calls
            bodies = [json.dumps({"image": p}).encode() for p in payloads]
            lat, bad, sent, load_s = closed_loop(srv.base, bodies, LOAD_SECONDS)
            torch.cuda.synchronize()
            del engine.dispatch_device_batch
            settle()
            load_steps = model.decode_step_calls - steps0
            load_dev = spans.loop_ms() / max(1, load_steps)
            load_wall = {b: sum(ms) / len(ms) for b, ms in sorted(per_bucket.items())}
            spans.remove()
            launches += decode_attention.launches
            steps += model.decode_step_calls
            check(fa.launches == 0, "flash_attention launched at S=257")
            _, stats = http_get(srv.base, "/stats")

            # the boundaries: an oversized body, an undecodable payload
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
            conn.putrequest("POST", "/v1/caption")
            conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
            conn.putheader("Content-Type", "application/json")
            conn.endheaders()
            too_big = conn.getresponse().status
            conn.close()
            undecodable, _ = http_post(srv.base, json.dumps(
                {"image": base64.b64encode(b"not an image").decode()}).encode())
    finally:
        batcher.close()
        engine.close()
    check(too_big == 413, "an oversized body got {}".format(too_big))
    check(undecodable == 400, "an undecodable payload got {}".format(undecodable))
    check(not bad and stats["errors"] == 0, "serving errors: clients {} stats {}".format(
        sorted(set(bad)), stats["errors"]))
    check(stats["requests"] == n + sent, "stats count {} requests, {} sent".format(
        stats["requests"], n + sent))
    check(steps > 0 and launches == model.cfg.num_layers * steps,
          "decode_attention launches {} != {} layers x {} steps".format(
              launches, model.cfg.num_layers, steps))
    lat = np.sort(np.asarray(lat)) * 1e3
    log("serving bf16+int8: warm() {:.1f} s for buckets {} x prefix lengths 1 and {}; {} requests "
        "at once: {} of {} replies equal generate_batch's at the batcher's device batch size "
        "(agreement {:.1%}), dispatches (real, device rows) {}".format(
            warm_s, batcher.buckets, len(engine.encode_prefix(SERVE_QUESTION)), n, n - len(differ),
            n, agree, sizes))
    log("serving load: {} closed-loop clients for {:.1f} s: {} requests, {:.2f} requests/s, latency "
        "p50 {:.1f} ms p99 {:.1f} ms; /stats: batches {} batch-size histogram {} padded slots {} "
        "errors {} rejected {}; 413 on a body over MAX_BODY_BYTES, 400 on an undecodable payload "
        "[{}]".format(LOAD_CLIENTS, load_s, sent, sent / load_s, np.percentile(lat, 50),
                      np.percentile(lat, 99), stats["batches"],
                      dict(sorted((int(k), v) for k, v in stats["batch_size_hist"].items())),
                      stats["padded_slots"], stats["errors"], stats["rejected"], card))
    log("serving: ms per beam step (device events: the searches less encode and prefill): "
        "with the clients {:.3f} over all {} steps; dispatch host ms per bucket {} (the upload "
        "and the search enqueued); alone, one batch of 16 {:.3f} device {:.3f} wall, of 32 "
        "{:.3f} device {:.3f} wall; phase 5's engine (32) {:.3f} device; decode_attention "
        "launches {} = {} x {} steps, flash_attention 0 [{}]".format(
            load_dev, load_steps, {b: round(w, 3) for b, w in load_wall.items()}, *alone[16],
            *alone[32], coco_step_ms, launches, model.cfg.num_layers, steps, card))
    peak_memory("serving", card)
    del engine, batcher, model
    gc.collect()  # the stacks' reference cycles (threads, closures) hold their weights
    torch.cuda.empty_cache()
    return launches, (sent / load_s, np.percentile(lat, 99))


class StepLog(object):
    """Records a model's prefill and decode_step calls until `remove`: the
    tokens and ancestry table each step was fed, and the f32 logits of
    each call (on the CPU); logits[t] are what the search's step t
    decided on."""

    def __init__(self, model):
        self.model, self.fed, self.logits = model, [], []
        prefill, step = model.prefill, model.decode_step

        def logged_prefill(*a, **kw):
            out = prefill(*a, **kw)
            self.logits.append(out[0].float().cpu())
            return out

        def logged_step(tokens, cache, *a, **kw):
            self.fed.append((tokens.cpu(), cache.anc.cpu()))
            out = step(tokens, cache, *a, **kw)
            self.logits.append(out[0].float().cpu())
            return out

        model.prefill, model.decode_step = logged_prefill, logged_step

    def remove(self):
        del self.model.prefill, self.model.decode_step


def sampling_parting_report(cpu_model, x, logs, table, beam, parted):
    """Where the sampled f32 searches of the card and the CPU part, held to
    an f64 witness, as phase 17's `parting_report` holds greedy.  The
    parting step s is the first whose fed tokens or ancestry differ; up to
    it both searches decided on the same state, so their logits there
    differ by rounding.  The f64 model replays the CPU's fed tokens to s.
    In the sampled branch's units (lt = penalised logits / temperature),
    D = ROUNDING_X x the CPU f32's largest error against f64 over the
    parting groups' rows; the card's error must be within D, and the
    decision must be a near-tie in f64: the gap between the P-th and the
    next Gumbel-perturbed value, or between the top-k cut's k-th and next
    logit, or the top-p cut's distance in cumulative probability, under
    2D on some row of the group.  Fails otherwise; returns the report."""
    import dataclasses

    import torch

    from gitax_torch.decode.beam import _tile_beams, top_k_top_p_filter
    from gitax_torch.models.git import GitModel

    card, cpu = logs["card"], logs["cpu"]
    n = min(len(card.fed), len(cpu.fed))
    diff = [t for t in range(n) if not (torch.equal(card.fed[t][0], cpu.fed[t][0])
                                        and torch.equal(card.fed[t][1], cpu.fed[t][1]))]
    check(diff or len(card.fed) != len(cpu.fed), "sampling f32: rows {} part with every fed "
          "token equal (a hypothesis-score tie); no witness for that".format(parted))
    s = diff[0] if diff else n
    k, p = beam.num_beams, beam.per_node_beam_size
    rows = sorted({int(r) for r in torch.nonzero(
        (card.fed[s][0] != cpu.fed[s][0]) | (card.fed[s][1] != cpu.fed[s][1]).any(1)).flatten()}
        if s < n else range(card.logits[0].shape[0] * k))
    groups = sorted({r // k for r in rows})
    m64 = GitModel(cpu_model.cfg, device="cpu", dtype=torch.float64)
    m64.load_state_dict(cpu_model.state_dict())
    with torch.inference_mode():
        visual, _ = m64.build_memory(x.double(), dtype=torch.float64)
        visual = visual.repeat_interleave(SAMPLE_R, 0)
        prefix = torch.full((visual.shape[0], 1), 101, dtype=torch.long)
        logits, cache = m64.prefill(visual, prefix, beam.max_steps, None, torch.float64)
        logits = logits.repeat_interleave(k, 0)
        cache = _tile_beams(cache, k)
        for t in range(s):
            cache = dataclasses.replace(cache, anc=cpu.fed[t][1].to(torch.int32))
            logits, cache = m64.decode_step(cpu.fed[t][0], cache, torch.float64)
    del m64

    def lt_of(lg, r):
        """The sampled branch's tempered, penalised logits of row r at
        step s, in f64 (the penalty's mask from the CPU's fed tokens)."""
        lg = lg[r].double()
        # the [CLS] prefix and the tokens of the row's ancestry: position
        # 1 + t holds what step t fed to the row the last table names
        seen = {101}
        if s:
            anc = cpu.fed[s - 1][1][r]
            seen |= {int(cpu.fed[t][0][(r // k) * k + int(anc[1 + t])]) for t in range(s)}
        idx = torch.tensor(sorted(seen))
        v = lg[idx]
        lg = lg.clone()
        lg[idx] = torch.where(v < 0, v * beam.repetition_penalty, v / beam.repetition_penalty)
        return lg / beam.temperature

    lines = []
    group_rows = [r for g in groups for r in range(g * k, (g + 1) * k)]
    # step 0 decides on the prefill's logits, one row per group
    at_s = {w: lg.logits[s] if s else lg.logits[0].repeat_interleave(k, 0)
            for w, lg in (("cpu", cpu), ("card", card))}
    errs = {w: max((lt_of(lg, r) - lt_of(logits, r)).abs().max().item() for r in group_rows)
            for w, lg in at_s.items()}
    d = ROUNDING_X * max(errs["cpu"], 1e-30)
    check(errs["card"] <= d, "sampling f32: at step {} the card's logits are {:.3e} from f64's, "
          "over D = {:.3e}".format(s, errs["card"], d))
    for g in groups:
        margins = []
        for r in range(g * k, (g + 1) * k):
            lt = lt_of(logits, r)
            srt = torch.sort(lt, descending=True).values
            kept = top_k_top_p_filter(lt, beam.top_k, beam.top_p, min_tokens_to_keep=max(2, p))
            noisy = torch.sort(torch.where(torch.isfinite(kept), kept + table[s][r].double(),
                                           float("-inf")), descending=True).values
            cum = torch.cumsum(torch.softmax(srt[:beam.top_k], -1), -1)
            margins.append(min((noisy[p - 1] - noisy[p]).item(),
                               (srt[beam.top_k - 1] - srt[beam.top_k]).item(),
                               (cum - beam.top_p).abs().min().item()))
        lines.append("group {} step {}: f64 margin {:.3e}, 2D {:.3e} (CPU error {:.3e}, card "
                     "{:.3e})".format(g, s, min(margins), 2 * d, errs["cpu"], errs["card"]))
        check(min(margins) < 2 * d, "sampling f32: group {} parts at step {} where the f64 "
              "margin {:.3e} is not under 2D = {:.3e}".format(g, s, min(margins), 2 * d))
    return "; ".join(lines)


def noise_table(shape, steps, seed):
    """[steps, *shape] standard Gumbel noise drawn on the CPU from `seed`
    with the port's `gumbel_noise`."""
    import torch

    from gitax_torch.decode.beam import gumbel_noise

    return torch.stack([gumbel_noise(shape, torch.Generator().manual_seed(seed * 1000 + i))
                        for i in range(steps)])


def replayed(table):
    """A stand-in for `gumbel_noise` whose i-th call returns table[i] on
    its generator's device."""
    calls = {"i": 0}

    def replay(shape, generator):
        check(tuple(shape) == tuple(table.shape[1:]), "noise asked for {}".format(tuple(shape)))
        calls["i"] += 1
        return table[calls["i"] - 1].to(generator.device)

    return replay


def phase_sampling(card, cpu_model, images, seed):
    """19. Sampling on GIT_LARGE_COCO, bf16 + int8: do_sample with
    temperature 0.7, top-k 50, top-p 0.9, repetition penalty 1.2,
    num_return_sequences 2, B = SAMPLE_B, a torch.Generator on the card
    seeded from `seed`: deterministic per seed, another seed another set;
    vocab_kernel asked for and gated off (0 vocab_topk launches).  f32 on
    SAMPLE_F32_B images: the card's tokens equal the CPU port's with both
    given one replayed noise table.  Returns the decode_attention
    launches."""
    import torch

    from gitax_torch.decode import beam as beam_mod
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.ops.decode_attention import decode_attention
    from gitax_torch.ops.quant import quantize_git_model_

    torch.cuda.reset_peak_memory_stats()
    beam = BeamSearchConfig(num_beams=4, max_steps=41, norm_max_length=1024, do_sample=True,
                            temperature=0.7, top_k=50, top_p=0.9, repetition_penalty=1.2)
    model = quantize_git_model_(build_model("cuda", torch.bfloat16, cpu_model))
    check(not model.vocab_kernel_applies(beam), "the vocab kernel's gates let sampling through")
    x = normalized(images[:SAMPLE_B], torch.bfloat16)

    def run(s):
        g = torch.Generator("cuda").manual_seed(s)
        return model.generate(x, cls_prefix(x), beam=beam, dtype=torch.bfloat16, fast_prefill=True,
                              decode_kernel=True, vocab_kernel=True,
                              num_return_sequences=SAMPLE_R, rng=g)[0].cpu()

    run(seed)  # warm-up
    torch.cuda.synchronize()
    spans = SearchSpans(model)
    settle()
    vt.launches = decode_attention.launches = model.decode_step_calls = 0
    t0 = time.perf_counter()
    a = run(seed)
    wall = time.perf_counter() - t0
    settle()
    steps, launches = model.decode_step_calls, decode_attention.launches
    step_ms = spans.loop_ms() / steps
    spans.remove()
    b, c = run(seed), run(seed + 1)
    settle()
    check(vt.launches == 0, "vocab_topk launched {} times under sampling".format(vt.launches))
    check(launches == model.cfg.num_layers * steps, "decode_attention launches {} != {} x {} "
          "steps".format(launches, model.cfg.num_layers, steps))
    check(a.shape == (SAMPLE_B * SAMPLE_R, 40), "sampled shape {}".format(tuple(a.shape)))
    check(torch.equal(a, b), "two runs with seed {} differ".format(seed))
    check(not torch.equal(a, c), "seeds {} and {} give the same tokens".format(seed, seed + 1))
    per_input = [len({tuple(r) for r in a[i * SAMPLE_R:(i + 1) * SAMPLE_R].tolist()})
                 for i in range(SAMPLE_B)]
    log("sampling bf16+int8: B={} x R={} (beam 4, temperature 0.7, top-k 50, top-p 0.9, "
        "repetition penalty 1.2, torch.Generator('cuda') seed {}): {} beam steps, {:.3f} ms per "
        "beam step (device events: the search less encode and prefill), {:.1f} ms per step wall; "
        "same seed identical, seed {} "
        "differs; distinct outputs per input {} (of {}), {} distinct in all; vocab_topk launches "
        "0 (vocab_kernel asked for, gated off), decode_attention {} = {} x {} [{}]".format(
            SAMPLE_B, SAMPLE_R, seed, steps, step_ms, wall / steps * 1e3, seed + 1,
            dict(collections.Counter(per_input)), SAMPLE_R, len({tuple(r) for r in a.tolist()}),
            launches, model.cfg.num_layers, steps, card))
    peak_memory("sampling", card)
    del model, x
    torch.cuda.empty_cache()

    # f32: the card against the CPU port on one replayed noise table
    x32 = normalized(images[:SAMPLE_F32_B], torch.float32)
    bk = SAMPLE_F32_B * SAMPLE_R * beam.num_beams
    model = build_model("cuda", torch.float32, cpu_model)
    out, logs = {}, {}
    table = noise_table((bk, cpu_model.cfg.vocab_size), beam.max_steps, seed)
    orig = beam_mod.gumbel_noise
    try:
        for where, m, xx in (("card", model, x32), ("cpu", cpu_model, x32.cpu())):
            beam_mod.gumbel_noise = replayed(table)
            logs[where] = StepLog(m)
            settle()
            decode_attention.launches = m.decode_step_calls = 0
            try:
                # the eager loop: StepLog reads each step on the host
                out[where] = m.generate(xx, cls_prefix(xx), beam=beam, decode_kernel=True,
                                        vocab_kernel=True, num_return_sequences=SAMPLE_R,
                                        rng=torch.Generator(xx.device.type),
                                        eager_loop=True)[0].cpu()
            finally:
                logs[where].remove()
            if where == "card":
                check(decode_attention.launches == m.cfg.num_layers * m.decode_step_calls,
                      "f32 decode_attention launches {} != {} x {} steps".format(
                          decode_attention.launches, m.cfg.num_layers, m.decode_step_calls))
                launches += decode_attention.launches
    finally:
        beam_mod.gumbel_noise = orig
    parted = [i for i in range(out["card"].shape[0])
              if not torch.equal(out["card"][i], out["cpu"][i])]
    report = "none"
    if parted:
        report = sampling_parting_report(cpu_model, x32.cpu(), logs, table, beam, parted)
    log("sampling f32: {} images x R={} on one replayed noise table: {} of {} rows equal on the "
        "card and the CPU; {} distinct on the card; partings: {}".format(
            SAMPLE_F32_B, SAMPLE_R, out["card"].shape[0] - len(parted), out["card"].shape[0],
            len({tuple(r) for r in out["card"].tolist()}), report))
    del model, logs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def context_inputs(n, seed):
    """n random 224 px images and the phase's two ragged contexts: word ids
    of the tiny vocabulary, lengths 1 to CTX_TOKENS per row."""
    import numpy as np
    import torch

    from gitax_torch.tokenization import build_tiny_vocab

    rng = np.random.RandomState(seed)
    images = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(n)]
    words = len(build_tiny_vocab())
    toks, lens = [], []
    for tc in CTX_TOKENS:
        toks.append(torch.from_numpy(rng.randint(1000, words, (n, tc))).long())
        lens.append(torch.from_numpy(rng.randint(1, tc + 1, (n,))).long())
    return images, toks, lens


def phase_context(card, seed):
    """20. Text context on GIT_BASE_COCO at full width (ViT-B/16 at 224 px,
    M = 197, D = 768): B = 32, beam 4, two ragged contexts, so the memory
    is M + 48 = CTX_M tokens with a padded tail that kernel 1 reads
    through mem_bias.  bf16 and f32, kernel path against plain path; f32
    card against the CPU port on 8 rows; flash_attention 0 launches,
    decode_attention 6 x steps.  Returns those launches."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops.decode_attention import decode_attention

    torch.cuda.reset_peak_memory_stats()
    cpu_model = random_model("GIT_BASE_COCO", seed=3, gate=12)
    cfg = cpu_model.cfg
    check(cfg.visual_feature_size == cfg.hidden_size == 768 and cfg.encoder.num_tokens ==
          CTX_IMAGE, "not GIT_BASE at 224 px")
    images, toks, lens = context_inputs(32, seed)
    beam = BeamSearchConfig(num_beams=4, max_steps=41, norm_max_length=1024)
    out, launches, steps = {}, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model("cuda", dtype, cpu_model)
        x = normalized(images, dtype)
        ct, cl = [t.cuda() for t in toks], [l.cuda() for l in lens]
        with torch.inference_mode():
            _, valid = model.build_memory(x, ct, cl, dtype=dtype)
        check(valid.shape == (32, CTX_M) and not valid.all(), "memory_valid {}".format(
            tuple(valid.shape)))
        for kernel in (True, False):
            settle()
            decode_attention.launches = fa.launches = model.decode_step_calls = 0
            t0 = time.perf_counter()
            seqs, lp = model.generate(x, cls_prefix(x), beam=beam, dtype=dtype,
                                      decode_kernel=kernel, context_tokens=ct, context_lengths=cl)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            settle()
            check(seqs.shape == (32, 40) and torch.isfinite(lp.float()).all().item(),
                  "context {}: shape {}".format(dtype, tuple(seqs.shape)))
            check(fa.launches == 0, "flash_attention launched on a padded memory")
            if kernel:
                check(decode_attention.launches == cfg.num_layers * model.decode_step_calls,
                      "decode_attention launches {} != {} x {} steps".format(
                          decode_attention.launches, cfg.num_layers, model.decode_step_calls))
                launches += decode_attention.launches
                steps += model.decode_step_calls
            else:
                check(decode_attention.launches == 0, "the plain path launched kernel 1")
            out[dtype, kernel] = seqs.cpu()
            log("context {} {} path: 32 images + 2 contexts (M = {}), {} beam steps in {:.2f} s, "
                "{} distinct outputs [{}]".format(
                    str(dtype)[6:], "kernel" if kernel else "plain", CTX_M,
                    model.decode_step_calls, seconds, len({tuple(r) for r in seqs.tolist()}), card))
        if dtype == torch.float32:
            check(torch.equal(out[dtype, True], out[dtype, False]),
                  "context f32: the kernel path's tokens differ from the plain path's")
            cpu_seqs, _ = cpu_model.generate(x[:8].cpu(), cls_prefix(x[:8].cpu()), beam=beam,
                                             context_tokens=[t[:8] for t in toks],
                                             context_lengths=[l[:8] for l in lens])
            check(torch.equal(out[dtype, True][:8], cpu_seqs),
                  "context f32: the card's tokens differ from the CPU port's on 8 rows")
        del model, x
        torch.cuda.empty_cache()
    bf16 = (out[torch.bfloat16, True] == out[torch.bfloat16, False]).all(1).float().mean().item()
    log("context: f32 kernel path = plain path (32 rows), = the CPU port (8 rows); bf16 kernel "
        "path against plain path: {:.1%} of rows agree; flash_attention 0; decode_attention "
        "{} launches with mem_bias = {} x {} steps".format(bf16, launches, cfg.num_layers, steps))
    peak_memory("context", card)
    return launches


# -- training (phase 21) ----------------------------------------------------

TRAIN_TIMED = 10  # timed steps after the speed test's 2 warm-up steps
TRAIN_ROWS = 64  # the fine-tune's PNG TSV
# bf16 tolerance for two loss trajectories of the same steps
BF16_REL = 2.0 ** -7


def reduced_large(layers=2, num_layers=1):
    """GIT_LARGE_COCO's widths at a cut depth: `layers` encoder blocks and
    `num_layers` decoder layers."""
    import dataclasses

    from gitax_torch.models.config import config_from_param, get_model_param

    cfg = config_from_param(get_model_param("GIT_LARGE_COCO"))
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, layers=layers),
                               num_layers=num_layers)


def kernel_launches():
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.ops.decode_attention import decode_attention

    settle()
    return decode_attention.launches, fa.launches, vt.launches


def train_speed(card):
    """21a. GIT_LARGE_COCO at full width and depth through
    `train.speed_test_forward_backward` (B=32, bf16, fast_softmax, AdamW
    1e-5 in f32, 2 warm-up + TRAIN_TIMED steps on one batch), then with
    remat=True: finite and falling losses, lower peak memory with remat,
    the two loss trajectories within bf16's tolerance."""
    import math

    import torch

    from gitax_torch import train

    runs = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        out = train.speed_test_forward_backward(duplicate=16, iterations=TRAIN_TIMED,
                                                dtype="bfloat16", model_name="GIT_LARGE_COCO",
                                                remat=remat)
        losses = out["losses"]
        check(out["batch"] == 32 and len(losses) == TRAIN_TIMED + 2, "speed test: {} images, "
              "{} losses".format(out["batch"], len(losses)))
        check(all(math.isfinite(x) for x in losses), "train loss not finite: {}".format(losses))
        check(losses[-1] < losses[0], "train loss did not fall: {}".format(losses))
        log("train GIT_LARGE_COCO B=32 bf16 fast_softmax remat={}: {:.2f} images/s, {:.2f} ms per "
            "step over {} steps, peak {:.1f} MiB allocated; loss per step {} [{}]".format(
                remat, out["images_per_s"], out["ms_per_step"], TRAIN_TIMED,
                out["peak_memory_bytes"] / 2**20, ["%.4f" % x for x in losses], card))
        runs[remat] = out
    plain, remat = runs[False], runs[True]
    check(remat["peak_memory_bytes"] < plain["peak_memory_bytes"],
          "remat did not lower the peak: {} >= {}".format(remat["peak_memory_bytes"],
                                                          plain["peak_memory_bytes"]))
    worst = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"], plain["losses"]))
    check(worst <= BF16_REL, "remat's losses part from the plain run's by {:.3g} rel".format(worst))
    log("train remat: peak {:.1f} -> {:.1f} MiB ({:.1%}), {:.2f} -> {:.2f} ms per step, losses "
        "within {:.3g} rel of the plain run's (bound 2^-7) [{}]".format(
            plain["peak_memory_bytes"] / 2**20, remat["peak_memory_bytes"] / 2**20,
            remat["peak_memory_bytes"] / plain["peak_memory_bytes"], plain["ms_per_step"],
            remat["ms_per_step"], worst, card))
    return plain


def caption_batch(n, seed, t=14):
    """n random normalized 224 px images and token rows [CLS] w.. [SEP]
    with need_predict on the words and [SEP], from a seeded generator."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 224, 224, 3, generator=g)
    tokens = torch.randint(1000, 30000, (n, t), generator=g)
    tokens[:, 0], tokens[:, -1] = 101, 102
    need = torch.ones_like(tokens)
    need[:, 0] = 0
    return x, tokens, need


def train_step_profile(card, seed):
    """21b. Where one training step's time goes: GIT_LARGE_COCO B=32 bf16,
    split with CUDA events into the encoder's forward, the decoder's
    forward and loss, the decoder's backward, the encoder's backward (the
    memory's gradient carried across by hand) and AdamW; with
    fast_softmax (bf16 score math) and without (f32 score matmuls, TF32
    off); then one fast step under torch.profiler."""
    import torch

    from gitax_torch.models.config import config_from_param, get_model_param
    from gitax_torch.models import textual
    from gitax_torch.models.git import GitModel
    from gitax_torch.training import caption_loss, init_train_state
    from gitax_torch.training.trainer import ConstantSchedule, adamw, apply_gradients

    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_from_param(get_model_param("GIT_LARGE_COCO"))
    model = GitModel(cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-5), weight_decay=1e-4))
    x, tokens, need = (t.cuda() for t in caption_batch(32, seed))
    x = x.to(torch.bfloat16)
    names = ("encoder fwd", "decoder fwd + loss", "decoder bwd", "encoder bwd", "AdamW")

    def step(fast, events=None):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)] if events is not None \
            else None
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        mark(0)
        visual, _ = model.build_memory(x, dtype=torch.bfloat16, fast=True if fast else None,
                                       flash=False)
        mark(1)
        leaf = visual.detach().requires_grad_()
        logits = textual.textual_forward(model.textual, leaf, tokens, cfg,
                                         dtype=torch.bfloat16, fast=fast)
        loss = caption_loss(logits, tokens, need)
        mark(2)
        loss.backward()
        mark(3)
        visual.backward(leaf.grad)
        mark(4)
        apply_gradients(state)
        mark(5)
        if marks:
            torch.cuda.synchronize()
            events.append([marks[i].elapsed_time(marks[i + 1]) for i in range(5)])
        return loss

    for fast in (True, False):
        for _ in range(2):
            step(fast)
        spans = []
        for _ in range(3):
            step(fast, spans)
        mean = [sum(s[i] for s in spans) / len(spans) for i in range(5)]
        log("train step split, GIT_LARGE_COCO B=32 bf16 {}: {} = {:.2f} ms [{}]".format(
            "fast_softmax (bf16 scores)" if fast else "f32 scores",
            ", ".join("{} {:.2f}".format(n, v) for n, v in zip(names, mean)), sum(mean), card))
    profile_batch("train step (fast_softmax)", card, lambda: step(True))
    del model, state
    torch.cuda.empty_cache()


def train_f32_parity(card, seed):
    """21c. f32 (TF32 off) on the card against the CPU: GIT_LARGE_COCO's
    widths with 2 encoder blocks and 1 decoder layer, B=4: the loss within
    1e-5 rel, each parameter's gradient within 1e-4 relative L2 error (the
    decoder's key biases, zero in exact arithmetic, within 1e-6 of the
    largest gradient norm on both)."""
    import torch

    from gitax_torch.models.git import GitModel
    from gitax_torch.training import caption_loss

    cfg = reduced_large()
    cpu = GitModel(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))
    card_model = build_model("cuda", torch.float32, cpu)
    x, tokens, need = caption_batch(4, seed + 1)
    losses, grads = [], []
    for model in (cpu, card_model):
        dev = model.textual.output.bias.device
        model.trainable_(True)
        xt, tt, nt = x.to(dev), tokens.to(dev), need.to(dev)
        loss = caption_loss(model.forward_logits(xt, tt), tt, nt)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.double().cpu() for n, p in model.named_parameters()})
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    check(rel <= 1e-5, "f32 train loss card {} CPU {}: {:.3g} rel".format(losses[1], losses[0],
                                                                          rel))
    top = max(g.norm().item() for g in grads[0].values())
    worst, worst_name = 0.0, None
    for n, g in grads[0].items():
        d = grads[1][n]
        if n.endswith(".attention.self.key.bias"):
            check(g.norm() <= 1e-6 * top and d.norm() <= 1e-6 * top,
                  "{}: the key bias gradient is not ~0".format(n))
            continue
        err = ((d - g).norm() / g.norm()).item()
        if err > worst:
            worst, worst_name = err, n
    check(worst <= 1e-4, "f32 gradient {} card vs CPU: {:.3g} relative L2".format(worst_name,
                                                                                  worst))
    log("train f32 card vs CPU (GIT_LARGE_COCO widths, 2 encoder blocks, 1 decoder layer, B=4): "
        "loss {:.6f} vs {:.6f} ({:.3g} rel), worst gradient relative L2 {:.3g} ({}), {} "
        "parameters [{}]".format(losses[1], losses[0], rel, worst, worst_name, len(grads[0]), card))
    del cpu, card_model
    torch.cuda.empty_cache()


def train_scst(card, seed):
    """21d. One ScstTrainer.step on GIT_LARGE_COCO at full width and depth,
    f32 (run_scst's default), B=8, 5 samples, 40 decode steps, each
    image's references holding its first sample's caption: finite
    rewards and loss, a positive sample reward."""
    import math

    import torch

    from gitax_torch.models.config import config_from_param, get_model_param
    from gitax_torch.models.git import GitModel
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
    from gitax_torch.training import init_train_state
    from gitax_torch.training.scst import ScstTrainer
    from gitax_torch.training.trainer import ConstantSchedule, adamw

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    words = ["a", "dog", "cat", "on", "the", "mat", "red", "car"]
    tok = BertTokenizer(build_tiny_vocab(words))
    cfg = config_from_param(get_model_param("GIT_LARGE_COCO"))
    model = GitModel(cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
    state = init_train_state(model, *adamw(model, ConstantSchedule(2e-6)))
    trainer = ScstTrainer(model, tok, num_samples=5, max_steps=40)
    x = caption_batch(8, seed + 2)[0].cuda()
    # a first rollout from the same generator seed gives each image's
    # first sampled caption, which joins its references: the step's
    # rewards and advantages are then not all 0 (random weights emit
    # random words)
    seqs = trainer.rollout(x, [["a dog"]] * 8, torch.Generator(device="cuda").manual_seed(seed))[0]
    gts = [[trainer._decode(seqs[5 * i]), "a dog on the mat"] for i in range(8)]
    t0 = time.perf_counter()
    state, metrics = trainer.step(state, x, gts, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(state.step == 1 and all(math.isfinite(v) for v in metrics.values()),
          "SCST step: {}".format(metrics))
    check(metrics["reward_sample"] > 0 and metrics["loss"] != 0,
          "SCST step: the first samples scored nothing against their own captions: "
          "{}".format(metrics))
    log("train SCST GIT_LARGE_COCO f32 B=8 x 5 samples: loss {:.4f}, reward sample {:.4f} greedy "
        "{:.4f}, {:.2f} s [{}]".format(metrics["loss"], metrics["reward_sample"],
                                       metrics["reward_greedy"], seconds, card))
    peak_memory("train SCST", card)
    del model, state, trainer
    torch.cuda.empty_cache()


def train_finetune_resume(card, work, seed):
    """21e. run_finetune on the card over a TRAIN_ROWS-row PNG TSV
    (GIT_LARGE_COCO's widths, 2 encoder blocks, 1 decoder layer, bf16,
    B=8, 224 px single-scale): 4 steps saving every 2, then a second run
    resuming from the first's step 2 (copied alone into its own save_dir,
    as after a crash there): its weights and AdamW moments equal the
    continuous run's."""
    import json as js

    import numpy as np
    import torch

    from gitax_torch.ckpt import serialization
    from gitax_torch.io.tsv import tsv_writer
    from gitax_torch.models.git import GitModel
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
    from gitax_torch.training import run_finetune

    words = ["a", "dog", "cat", "on", "the", "mat", "red", "car", "sits", "road"]
    tok = BertTokenizer(build_tiny_vocab(words))
    rng = np.random.RandomState(seed)
    img_tsv, cap_tsv = os.path.join(work, "ft.img.tsv"), os.path.join(work, "ft.cap.tsv")
    keys = write_image_tsv(img_tsv, [rng.randint(0, 256, (256, 288, 3)).astype(np.uint8)
                                     for _ in range(TRAIN_ROWS)])
    tsv_writer(([k, js.dumps([{"caption": " ".join(rng.choice(words, 6))} for _ in range(2)])]
                for k in keys), cap_tsv)
    cfg = reduced_large()
    runs = {}
    for label in ("continuous", "resumed"):
        save_dir = os.path.join(work, "ft_" + label)
        if label == "resumed":
            shutil.copytree(os.path.join(work, "ft_continuous", "step_00000002"),
                            os.path.join(save_dir, "step_00000002"))
        model = GitModel(cfg, device="cuda").init_params(torch.Generator().manual_seed(
            seed if label == "continuous" else seed + 1))
        t0 = time.perf_counter()
        state = run_finetune(img_tsv, cap_tsv, model, num_steps=4, batch_size=8,
                             learning_rate=1e-4, warmup_steps=1, multi_scale=False,
                             save_dir=save_dir, save_every=2, tokenizer=tok, log_every=1,
                             seed=seed)
        torch.cuda.synchronize()
        check(state.step == 4 and serialization.latest_step(save_dir) == 4,
              "fine-tune {} ended at step {}".format(label, state.step))
        runs[label] = (state, time.perf_counter() - t0)
    (a, ta), (b, tb) = runs["continuous"], runs["resumed"]
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        check(torch.equal(x, y), "fine-tune: the resumed {} differs from the continuous "
              "run's".format(n))
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    check(all(torch.equal(sa[k][m], sb[k][m]) for k in sa for m in ("exp_avg", "exp_avg_sq")),
          "fine-tune: the resumed AdamW moments differ from the continuous run's")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(
        os.path.join(work, "ft_continuous", "step_00000002")) for f in fs)
    log("train fine-tune (GIT_LARGE_COCO widths, 2 + 1 layers, bf16, B=8, {} PNG rows): 4 steps "
        "in {:.2f} s saving steps 2 and 4 ({:.1f} MiB a step); resumed from step 2: steps 3-4 in "
        "{:.2f} s, weights and moments equal the continuous run's [{}]".format(
            TRAIN_ROWS, ta, size / 2**20, tb, card))
    del a, b, runs
    torch.cuda.empty_cache()


def train_refusals(card):
    """21f. Each kernel wrapper raises on CUDA inputs that autograd
    tracks, before it launches; so does the encoder's fused-attention
    path of a trainable model."""
    import torch

    from gitax_torch.ops import decode_attention as da
    from gitax_torch.ops import flash_attention as fa
    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.models.git import GitModel

    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(2, 16, 64, 64, requires_grad=True, **bf)
    h = torch.randn(8, 768, requires_grad=True, **bf)
    qd = torch.zeros(8, H * DH, requires_grad=True, **bf)
    calls = {
        "flash_attention_cuda": lambda: fa.flash_attention_cuda(q, q, q, torch.empty_like(q)),
        "flash_qkv_attention": lambda: fa.flash_qkv_attention(
            torch.randn(2, 64, 3 * 1024, requires_grad=True, **bf), 16),
        "decode_attention_cuda": lambda: da.decode_attention_cuda(
            qd, torch.zeros(8, 2 * H * DH, **bf), torch.zeros(T, 8, 2 * H * DH, **bf),
            torch.zeros(8, T, dtype=torch.int32, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"),
            torch.zeros(2, H, M, 2 * DH, **bf), beams=4, num_heads=H, head_dim=DH),
        "vocab_logits_topk_cuda": lambda: vt.vocab_logits_topk_cuda(
            h, torch.zeros(768, 1024, dtype=torch.int8, device="cuda"),
            torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")),
    }
    cfg = reduced_large(layers=1, num_layers=1)
    model = GitModel(cfg, device="cuda").init_params(torch.Generator().manual_seed(0))
    model.trainable_(True)
    calls["encode_images(flash=True)"] = lambda: model.encode_images(
        torch.randn(2, 224, 224, 3, **bf), dtype=torch.bfloat16, flash=True)
    before = kernel_launches()
    for name, fn in calls.items():
        try:
            fn()
        except RuntimeError as e:
            check("no backward" in str(e), "{}: {}".format(name, e))
        else:
            check(False, "{} took inputs that require grad".format(name))
    check(kernel_launches() == before, "a refused call launched a kernel")
    log("train: the kernel wrappers raise under autograd on the card ({}), no launch "
        "[{}]".format(", ".join(calls), card))
    del model
    torch.cuda.empty_cache()


def phase_train(card, work, seed):
    """21. Training on the card: speed and remat, the step's split and
    profile, f32 card vs CPU, SCST, a fine-tune with resume, the
    wrappers' refusals.  Launches none of the three kernels."""
    before = kernel_launches()
    t0 = time.perf_counter()
    rate = train_speed(card)["images_per_s"]
    train_step_profile(card, seed)
    train_f32_parity(card, seed)
    train_scst(card, seed)
    train_finetune_resume(card, work, seed)
    train_refusals(card)
    check(kernel_launches() == before, "training launched kernels: {} -> {}".format(
        before, kernel_launches()))
    log("phase 21 (training) {:.1f} s; launched none of the three kernels (decode_attention, "
        "flash_attention, vocab_topk: +0 each)".format(time.perf_counter() - t0))
    return rate


# -- training on a mesh (phase 22) -------------------------------------------

MESH_STEPS = 3  # (a)'s steps; (b) times this many after one warm-up
MESH_TIMEOUT_S = 600  # a group of ranks that runs longer is killed and fails the phase
MESH_WORDS = ["a", "dog", "cat", "on", "the", "mat", "red", "car", "sits", "road"]


def mesh_layout(world, cards):
    """(share_card, label): NCCL, one card a rank, where the machine has
    a card for every rank; else every rank on card 0 over gloo (a
    rehearsal of the mesh, which measures nothing about scaling)."""
    if cards >= world:
        return False, "NCCL, one card a rank"
    return True, "{} ranks sharing card 0 over gloo (a rehearsal: no scaling figure)".format(world)


def mesh_batch(n, seed):
    """`caption_batch` as a dict of CPU tensors (every rank builds the
    same global batch from the seed and keeps its rows)."""
    x, tokens, need = caption_batch(n, seed)
    return {"image": x, "caption_tokens": tokens, "need_predict": need}


def mesh_parity_model(device, seed):
    """(a)'s model and optimizer: GIT_LARGE_COCO's widths at 2 encoder
    blocks and 1 decoder layer, f32 from the seeded CPU generator, AdamW
    at a constant 1e-5 (weight decay 1e-4)."""
    import torch

    from gitax_torch.models.git import GitModel

    return GitModel(reduced_large(), device=device).init_params(
        torch.Generator().manual_seed(seed))


def mesh_f32_steps(model, batch, zero1=True):
    """MESH_STEPS f32 steps on `batch` (this rank's rows); the losses."""
    from gitax_torch.training import init_train_state, make_train_step
    from gitax_torch.training.trainer import ConstantSchedule, adamw, to_device

    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-5), weight_decay=1e-4,
                                           zero1=zero1))
    step = make_train_step(model)
    dev = model.textual.output.bias.device
    b = to_device(batch, dev)
    return [step(state, b)[1]["loss"].item() for _ in range(MESH_STEPS)]


def mesh_reference(work, seed):
    """22a's one-card run in this process: its losses; its weights saved
    to work/mesh_ref.pt for the ranks to compare with."""
    import torch

    model = mesh_parity_model("cuda", seed)
    losses = mesh_f32_steps(model, mesh_batch(8, seed + 3), zero1=False)
    torch.save({n: t.detach().cpu() for n, t in model.state_dict().items()},
               os.path.join(work, "mesh_ref.pt"))
    del model
    torch.cuda.empty_cache()
    return losses


def rank_parity(shape, dev, backend, work, seed):
    """22a on one rank: the same model sharded on a `shape` mesh, ZeRO-1,
    the rows of the same batch; on rank 0 the relative L2 distance of the
    gathered weights from the one-card run's."""
    import torch

    from gitax_torch.parallel.mesh import gather_params, make_mesh, shard_params

    mesh = make_mesh(*shape, device=dev, backend=backend)
    model = shard_params(mesh_parity_model(dev, seed), mesh)
    t0 = time.perf_counter()
    losses = mesh_f32_steps(model, mesh.local_batch(mesh_batch(8, seed + 3)))
    seconds = time.perf_counter() - t0
    full = gather_params(model)
    out = {"losses": losses, "seconds": seconds}
    if mesh.rank == 0:
        ref = torch.load(os.path.join(work, "mesh_ref.pt"), weights_only=True)
        names = [n for n in ref if n != "textual.output.weight"]  # the tied head: words
        diff = sum((full[n].double().cpu() - ref[n].double()).square().sum() for n in names)
        norm = sum(ref[n].double().square().sum() for n in names)
        out["rel_l2"] = float((diff / norm).sqrt())
    del model, full
    torch.cuda.empty_cache()
    return out


def rank_speed(shape, zero1, global_batch, dev, backend, seed):
    """22b on one rank: GIT_LARGE_COCO at full width and depth on a
    `shape` mesh, bf16 with fast_softmax, AdamW(1e-5) in f32, ZeRO-1 on or
    off, `global_batch` rows split over the data ranks: one warm-up step,
    then MESH_STEPS timed (host clock, each end behind a synchronize and a
    barrier); ms a step, the losses and this rank's peak memory from the
    model's creation on."""
    import math

    import torch

    from gitax_torch.models.config import config_from_param, get_model_param
    from gitax_torch.models.git import GitModel
    from gitax_torch.parallel import comm
    from gitax_torch.parallel.mesh import make_mesh, shard_params
    from gitax_torch.training import init_train_state, make_train_step
    from gitax_torch.training.trainer import ConstantSchedule, adamw, to_device

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(*shape, device=dev, backend=backend)
    cfg = config_from_param(get_model_param("GIT_LARGE_COCO"))
    model = GitModel(cfg, device=dev).init_params(torch.Generator().manual_seed(seed))
    shard_params(model, mesh)
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-5), weight_decay=1e-4,
                                           zero1=zero1))
    step = make_train_step(model, dtype=torch.bfloat16, fast_softmax=True)
    batch = to_device(mesh.local_batch(mesh_batch(global_batch, seed)), dev)
    batch["image"] = batch["image"].to(torch.bfloat16)
    losses = [step(state, batch)[1]["loss"]]
    torch.cuda.synchronize(dev)
    comm.barrier(dev)
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        losses.append(step(state, batch)[1]["loss"])
    torch.cuda.synchronize(dev)
    comm.barrier(dev)
    ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
    losses = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in losses), "mesh {} losses {}".format(shape, losses))
    out = {"ms": ms, "losses": losses, "peak": torch.cuda.max_memory_allocated(dev),
           "batch": global_batch, "images_per_s": global_batch / ms * 1e3}
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_finetune(dev, backend, work, seed):
    """22c on one rank: run_finetune on a [2, 1] mesh over work's PNG TSV
    (GIT_LARGE_COCO's widths, 2 + 1 layers, bf16, B=8, ZeRO-1), 4 steps
    saving every 2, then a run resumed from its step 2 (copied alone into
    a save_dir of its own, from other starting weights); on rank 0 whether
    the resumed run's step-4 checkpoint (weights and moments) equals the
    continuous run's."""
    import torch
    import torch.distributed as dist

    from gitax_torch.models.git import GitModel
    from gitax_torch.parallel import comm
    from gitax_torch.parallel.mesh import make_mesh
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
    from gitax_torch.training import run_finetune

    tok = BertTokenizer(build_tiny_vocab(MESH_WORDS))
    seconds = {}
    for label in ("continuous", "resumed"):
        save_dir = os.path.join(work, "mesh_ft_" + label)
        if label == "resumed" and dist.get_rank() == 0:
            shutil.copytree(os.path.join(work, "mesh_ft_continuous", "step_00000002"),
                            os.path.join(save_dir, "step_00000002"))
        comm.barrier(dev)
        mesh = make_mesh(data=2, model=1, device=dev, backend=backend)
        model = GitModel(reduced_large(), device=dev).init_params(torch.Generator().manual_seed(
            seed if label == "continuous" else seed + 1))
        t0 = time.perf_counter()
        state = run_finetune(os.path.join(work, "mesh.img.tsv"), os.path.join(work, "mesh.cap.tsv"),
                             model, num_steps=4, batch_size=8, learning_rate=1e-4, warmup_steps=1,
                             multi_scale=False, save_dir=save_dir, save_every=2, tokenizer=tok,
                             log_every=1, seed=seed, mesh=mesh)
        seconds[label] = time.perf_counter() - t0
        check(state.step == 4, "mesh fine-tune {} ended at step {}".format(label, state.step))
        del model, state
        torch.cuda.empty_cache()
    out = {"seconds": seconds}
    if dist.get_rank() == 0:
        a, b = (torch.load(os.path.join(work, "mesh_ft_" + label, "step_00000004", "state.pt"),
                           weights_only=True) for label in ("continuous", "resumed"))
        out["weights_equal"] = all(torch.equal(x, b["model"][n]) for n, x in a["model"].items())
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        out["moments_equal"] = all(torch.equal(sa[k][m], sb[k][m]) for k in sa
                                   for m in ("exp_avg", "exp_avg_sq"))
        out["steps"] = sorted({float(st["step"]) for st in sb.values()})
        out["files"] = sorted(os.listdir(os.path.join(work, "mesh_ft_continuous")))
    return out


def mesh_rank(rank, world, init_method, work, seed, share):
    """One rank of phase 22 (a spawned process: it imports gitax_torch and
    nothing of JAX): joins the group, runs its world's parts and writes
    its results to work/mesh{world}_rank{rank}.json."""
    import torch
    import torch.distributed as dist

    from gitax_torch.runtime.distributed import init_training_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, backend = init_training_group(rank, world, init_method, share_card=share,
                                       timeout_s=MESH_TIMEOUT_S)
    try:
        out = {}
        b = {}
        if world == 2:
            out["a"] = {"2x1": rank_parity((2, 1), dev, backend, work, seed),
                        "1x2": rank_parity((1, 2), dev, backend, work, seed)}
            # ZeRO-1 off first: run first in its process on two H100s, ZeRO-1
            # read 326 ms a step at 16 rows a rank, and 179.5 ms at 32 rows a
            # rank after the others; its cost is read after a warm process
            b = {"2x1": rank_speed((2, 1), False, 32, dev, backend, seed),
                 "2x1 zero1": rank_speed((2, 1), True, 32, dev, backend, seed),
                 "1x2": rank_speed((1, 2), True, 32, dev, backend, seed)}
            out["c"] = rank_finetune(dev, backend, work, seed)
        else:
            out["a"] = {"2x2": rank_parity((2, 2), dev, backend, work, seed)}
        if not share:  # one card a rank: the scaling figure, 32 rows a rank as phase 21
            b["{}x1 zero1, 32 a rank".format(world)] = rank_speed((world, 1), True, 32 * world,
                                                                  dev, backend, seed)
        out["b"] = b
        out["launches"] = list(kernel_launches())
        out["jax"] = "jax" in sys.modules
        with open(os.path.join(work, "mesh{}_rank{}.json".format(world, rank)), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world, work, seed, share):
    """Start `world` ranks of `mesh_rank` (spawned interpreters, a file://
    rendezvous in work), wait for them (killing them all after
    MESH_TIMEOUT_S) and return each rank's results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    init = "file://" + os.path.abspath(os.path.join(work, "rendezvous{}".format(world)))
    procs = [ctx.Process(target=mesh_rank, args=(r, world, init, work, seed, share))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, "phase 22: the ranks of the {}-rank group exited {}".format(
        world, codes))
    out = []
    for r in range(world):
        with open(os.path.join(work, "mesh{}_rank{}.json".format(world, r))) as f:
            out.append(json.load(f))
    return out


def phase_mesh(card, work, seed, train_rate):
    """22. Training on a mesh: f32 parity of the [2, 1], [1, 2] and [2, 2]
    meshes with the one-card run (a), GIT_LARGE_COCO at full width and
    depth on [2, 1] with ZeRO-1 on and off and on [1, 2] with each rank's
    peak memory (b), a fine-tune resumed on the mesh (c).  The ranks are
    spawned processes; launches none of the three kernels."""
    import numpy as np
    import torch

    from gitax_torch.io.tsv import tsv_writer

    t_phase = time.perf_counter()
    before = kernel_launches()
    cards = torch.cuda.device_count()
    rng = np.random.RandomState(seed)
    keys = write_image_tsv(os.path.join(work, "mesh.img.tsv"),
                           [rng.randint(0, 256, (256, 288, 3)).astype(np.uint8)
                            for _ in range(32)])
    tsv_writer(([k, json.dumps([{"caption": " ".join(rng.choice(MESH_WORDS, 6))}
                                for _ in range(2)])] for k in keys),
               os.path.join(work, "mesh.cap.tsv"))
    ref = mesh_reference(work, seed)
    groups = {}
    for world in (2, 4):
        share, label = mesh_layout(world, cards)
        t0 = time.perf_counter()
        groups[world] = run_ranks(world, work, seed, share)
        log("mesh: the {}-rank group ({}) ran in {:.1f} s".format(world, label,
                                                                   time.perf_counter() - t0))
    for world, ranks in groups.items():
        check(not any(r["jax"] for r in ranks), "a rank imported jax")
        check(all(r["launches"] == [0, 0, 0] for r in ranks),
              "a rank launched a kernel: {}".format([r["launches"] for r in ranks]))
    # (a) f32 parity with the one-card run
    for world, ranks in groups.items():
        for shape, res in ranks[0]["a"].items():
            rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref))
            check(rel <= 1e-5, "mesh {} f32 loss {} vs one card {}: {:.3g} rel".format(
                shape, res["losses"], ref, rel))
            check(res["rel_l2"] <= 1e-6, "mesh {} f32 weights after {} steps: {:.3g} relative L2 "
                  "from the one-card run's".format(shape, MESH_STEPS, res["rel_l2"]))
            log("mesh {} f32 (GIT_LARGE_COCO widths, 2 encoder blocks, 1 decoder layer, B=8, "
                "ZeRO-1, {} steps): losses {} vs one card {} (worst {:.3g} rel), weights {:.3g} "
                "relative L2 from the one-card run's, {:.2f} s [{}]".format(
                    shape, MESH_STEPS, ["%.7f" % x for x in res["losses"]],
                    ["%.7f" % x for x in ref], rel, res["rel_l2"], res["seconds"], card))
    # (b) full width and depth, bf16
    speeds = {}
    for world, ranks in groups.items():
        for name in ranks[0]["b"]:
            res = [r["b"][name] for r in ranks]
            speeds[name] = res
            log("mesh {} GIT_LARGE_COCO B={} bf16 fast_softmax: {:.2f} ms a step ({:.2f} images/s; "
                "one card, phase 21: {:.2f} images/s), peak memory per rank {} MiB, losses {} "
                "[{}; {}]".format(name, res[0]["batch"], res[0]["ms"], res[0]["images_per_s"],
                                  train_rate,
                                  ["%.1f" % (r["peak"] / 2**20) for r in res],
                                  ["%.4f" % x for x in res[0]["losses"]], card,
                                  mesh_layout(world, cards)[1]))
    on, off = speeds["2x1 zero1"], speeds["2x1"]
    check(all(a["peak"] < b["peak"] for a, b in zip(on, off)),
          "ZeRO-1 did not lower a rank's peak: {} vs {}".format(
              [a["peak"] for a in on], [b["peak"] for b in off]))
    log("mesh 2x1 ZeRO-1: peak per rank {} -> {} MiB (saves {} MiB) [{}]".format(
        ["%.1f" % (b["peak"] / 2**20) for b in off], ["%.1f" % (a["peak"] / 2**20) for a in on],
        ["%.1f" % ((b["peak"] - a["peak"]) / 2**20) for a, b in zip(on, off)], card))
    # (c) the fine-tune resumed on the mesh
    ft = groups[2][0]["c"]
    check(ft["files"] == ["step_00000002", "step_00000004"], "mesh fine-tune wrote {}".format(
        ft["files"]))
    check(ft["weights_equal"] and ft["moments_equal"] and ft["steps"] == [4.0],
          "mesh fine-tune: the resumed run differs from the continuous one: {}".format(ft))
    log("mesh fine-tune [2, 1] (GIT_LARGE_COCO widths, 2 + 1 layers, bf16, B=8, ZeRO-1, 32 PNG "
        "rows): 4 steps saving 2 and 4 in {:.2f} s; resumed from step 2 in {:.2f} s: weights, "
        "moments and step count equal the continuous run's [{}]".format(
            ft["seconds"]["continuous"], ft["seconds"]["resumed"], card))
    check(kernel_launches() == before, "phase 22 launched kernels")
    log("phase 22 (training on a mesh) {:.1f} s; launched none of the three kernels (+0 each, "
        "in every rank)".format(time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# 23. inference on a mesh
# ---------------------------------------------------------------------------

MESH_INFER_TIMEOUT_S = 300  # the group's timeout: a rank that fails ends the others' waits
# a rank of a 2-wide model group: the decoder's 12 heads and the encoder's
# 16 split in two
RANK_H, RANK_ENC_H = H // 2, ENC_H // 2
P23_PARITY_ROWS, P23_PARITY_PAIRS = 8, 4  # (a): rows a data rank, COCO and VQA
P23_ROWS = 32  # (b): rows a data rank
P23_TSV_ROWS = 16  # (c): the f32 TSV
P23_LOAD_SECONDS = 10.0
P23_REQUESTS = 4  # (c): f32 replies held to one card's


def rank_stats(control, dev, world, reset):
    """[world, 4] on every rank of phase 23's group: each rank's peak
    device memory since its last reset and its three kernels' launch
    counts (an all-reduce of zero-padded rows over the host); reset: start
    each rank's peak anew."""
    import torch
    import torch.distributed as dist

    t = torch.zeros(world, 4, dtype=torch.float64)
    t[dist.get_rank()] = torch.tensor([torch.cuda.max_memory_allocated(dev)]
                                      + list(kernel_launches()), dtype=torch.float64)
    dist.all_reduce(t, group=control)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return t


def infer_follower(rank, world, init_method, share):
    """A rank 1.. of phase 23's group (a spawned process: it imports
    gitax_torch and nothing of JAX), as a rank of a launch of data x
    model processes: it runs rank 0's commands until None comes.
    ('engine', shape): the follower of rank 0's engine on a `shape` mesh;
    ('call', module, name, cwd, kwargs): an entry point, which takes the
    launch's ranks and follows rank 0's engine; ('stats', reset):
    `rank_stats`."""
    import importlib

    import torch
    import torch.distributed as dist

    from gitax_torch.parallel import comm
    from gitax_torch.parallel.mesh import make_mesh
    from gitax_torch.runtime.distributed import init_training_group
    from gitax_torch.runtime.engine import follow_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, backend = init_training_group(rank, world, init_method, share_card=share,
                                       timeout_s=MESH_INFER_TIMEOUT_S)
    torch.cuda.set_device(dev)
    torch.cuda.init()  # the memory statistics need the card's context
    control = dist.new_group(backend="gloo")
    try:
        while True:
            cmd = comm.broadcast_object(None, 0, control)
            if cmd is None:
                return
            if cmd[0] == "engine":
                follow_mesh(make_mesh(*cmd[1], device=dev, backend=backend))
            elif cmd[0] == "call":
                _, module, name, cwd, kwargs = cmd
                old = os.getcwd()
                os.chdir(cwd)
                try:
                    getattr(importlib.import_module(module), name)(**kwargs)
                finally:
                    os.chdir(old)
            else:
                rank_stats(control, dev, world, cmd[1])
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


class InferGroup(object):
    """Phase 23's group of `world` ranks: this process is rank 0, ranks 1..
    are spawned `infer_follower`s; NCCL a card a rank, or every rank on
    card 0 over gloo (`share`)."""

    def __init__(self, world, share):
        import torch.distributed as dist

        from gitax_torch.runtime.distributed import SpawnedRanks, init_training_group

        self.world = world
        self.ranks = SpawnedRanks("chip_smoke:infer_follower", world, (share,))
        try:
            self.dev, self.backend = init_training_group(0, world, self.ranks.init_method,
                                                         share_card=share,
                                                         timeout_s=MESH_INFER_TIMEOUT_S)
            self.control = dist.new_group(backend="gloo")
        except BaseException:
            self.ranks.join(ok=False)
            raise

    def send(self, cmd):
        from gitax_torch.parallel import comm

        comm.broadcast_object(cmd, 0, self.control)

    def engine(self, shape, model, tok, **kw):
        """Rank 0's engine on a `shape` mesh of the group (the others
        follow it), counting the elements that differ within a model
        group."""
        from gitax_torch.parallel.mesh import make_mesh
        from gitax_torch.runtime.engine import CaptionEngine

        self.send(("engine", shape))
        mesh = make_mesh(*shape, device=self.dev, backend=self.backend)
        return CaptionEngine(model, tok, mesh=mesh, check_groups=True, **kw)

    def call(self, module, name, cwd, kwargs, own=None):
        """The entry point module.name(**kwargs) on every rank, in `cwd`;
        rank 0 runs `own` instead where given (the same call by another
        door, the -p command line)."""
        import importlib

        self.send(("call", module, name, cwd, kwargs))
        old = os.getcwd()
        os.chdir(cwd)
        try:
            if own is not None:
                return own()
            return getattr(importlib.import_module(module), name)(**kwargs)
        finally:
            os.chdir(old)

    def stats(self, reset=True):
        """`rank_stats` of every rank: (peak MiB a rank, launches summed
        over the ranks)."""
        self.send(("stats", reset))
        t = rank_stats(self.control, self.dev, self.world, reset)
        return [p / 2**20 for p in t[:, 0].tolist()], [int(x) for x in t[:, 1:].sum(0).tolist()]

    def close(self, ok=True):
        import torch.distributed as dist

        try:
            if ok:
                self.send(None)
        finally:
            dist.destroy_process_group()
            self.ranks.join(ok)


def mesh_run(group, run):
    """run() between two `stats` reads: (its result, the peak MiB of each
    rank, the three kernels' launches over every rank).  An engine on the
    group is made and closed inside run(): its followers read no command
    of the group until it closes."""
    before = group.stats(reset=True)[1]
    out = run()
    peaks, after = group.stats(reset=True)
    return out, peaks, [a - b for a, b in zip(after, before)]


def engine_tokens(engine, items, prefixes, rows, generate=None):
    """The search's sequences for `items` in device batches of `rows`
    (the last one padded by the engine), on the host [N, L]."""
    import numpy as np

    out = []
    for i in range(0, len(items), rows):
        seqs = engine.dispatch_device_batch(np.stack(items[i:i + rows]),
                                            np.asarray(prefixes[i:i + rows]), **(generate or {}))
        out.append(engine.to_host(seqs)[:len(items[i:i + rows])])
    return np.concatenate(out)


def check_rank_kernels(card):
    """23's kernels at the shapes a rank gives them: a model rank of a
    2-wide group holds 6 of the decoder's 12 heads and 8 of the encoder's
    16 (kernel 1 at H=6, B=32, M 257 and 1201; kernel 2's encoder entry at
    H=8, S=1201 and its prefill entry at H=6, M=1201 + 12); a data rank of
    2 at a global batch of 32 feeds kernel 3 R = 4 x 16 = 64 rows.  Each
    held to its plain version at phases 3, 4 and 9's bars, and timed
    beside its bound, its plain version and (kernel 2) SDPA."""
    import torch

    from gitax_torch.ops import vocab_topk as vt
    from gitax_torch.ops.decode_attention import cluster_plan

    g = torch.Generator().manual_seed(23)
    kw = dict(beams=K, num_heads=RANK_H, head_dim=DH)
    kinds = (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
             ("bf16+int8mem", torch.bfloat16, True))
    worst = {}
    for m in (M, 1201):
        for name, dtype, mem_int8 in kinds:
            for pos in (0, 12, T - 1):
                a = decode_inputs(g, dtype, mem_int8, pos, m, b=B, h=RANK_H)
                label = "{:18s} H={} M={:4d} pos={:2d} (cluster {})".format(
                    name, RANK_H, m, pos, cluster_plan(m, K, DH, T, a["mem_kv"].element_size())[0])
                err = check_decode_case(label, a, dtype, mem_int8, kw)
                if name == "bf16":
                    worst["decode_attention"] = max(worst.get("decode_attention", 0.0), err)
    for dtype, regime, std in ((torch.float32, "spread", 0.5), (torch.bfloat16, "spread", 0.5),
                               (torch.bfloat16, "peaked", 4.0)):
        for name, entry, h, s, m in (("encoder S=1201 H=8", "qkv", RANK_ENC_H, ENC_S, 0),
                                     ("prefill M=1201 Tp=12 H=6", "masked", RANK_H, PRE_M + PRE_TP,
                                      PRE_M)):
            err = check_flash_case(g, name, entry, B, h, s, m, dtype, regime, std)
            if dtype == torch.bfloat16 and regime == "spread":
                worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
    gv = torch.Generator(device="cuda").manual_seed(23)
    r = 4 * P23_ROWS // 2
    for dtype in (torch.float32, torch.bfloat16):
        for peaked in (False, True):
            args = vocab_inputs(gv, r, HEAD_V, HEAD_W, dtype, peaked)
            out = vt.vocab_logits_topk_cuda(*args)
            torch.cuda.synchronize()
            err, _ = check_vocab_call("vocab kernel {:4s} R={:3d} V={:5d} W={:4d} {}".format(
                "f32" if dtype == torch.float32 else "bf16", r, HEAD_V, HEAD_W,
                "peaked" if peaked else "N(0,1)"), *args, *out)
            if dtype == torch.bfloat16 and not peaked:
                worst["vocab_topk"] = err
            del args, out
    rows = {"decode_attention": [time_decode(card, g, m, b=B, h=RANK_H) for m in (M, 1201)],
            "flash_attention": [time_flash(card, g, B, RANK_ENC_H, ENC_S),
                                time_flash(card, g, B, RANK_H, PRE_M + PRE_TP, PRE_M,
                                           masked=True)],
            "vocab_topk": [time_vocab(card, gv, r)[0]]}
    torch.cuda.empty_cache()
    log("mesh kernels at a rank's shapes: kernel 1 at H={} (M 257, 1201; f32, bf16, bf16 with "
        "int8 memory; pos 0, 12, {}), kernel 2 at encoder H={} S=1201 and prefill H={} M=1201+12 "
        "(f32, bf16 spread and peaked), kernel 3 at R={} (f32, bf16; N(0,1), peaked) hold against "
        "their plain versions; worst bf16 error {}".format(
            RANK_H, T - 1, RANK_ENC_H, RANK_H, r, {k: "%.3e" % v for k, v in worst.items()}))
    return rows, worst


def p23_parity_model(seed):
    """(a)'s model: GIT_LARGE_COCO's widths at 2 encoder blocks and 1
    decoder layer, f32 from the seeded CPU generator, the EOS gate at 12,
    sharpened as phase 16 sharpens (captions that depend on the image)."""
    import torch

    from gitax_torch.models.git import GitModel, eos_gate_

    model = GitModel(reduced_large(), device="cpu").init_params(torch.Generator().manual_seed(seed))
    return sharpen_(eos_gate_(model, gate=12))


def p23_parity(card, group, shape, cpu_model, tok, inputs, want):
    """(a) on a `shape` mesh: the COCO rows and the VQA pairs at S=1201
    (the fused attention forced on in f32), the tokens against one card's
    (`want`), every model group's ranks equal; the launches over every
    rank."""
    import numpy as np
    import torch

    d = shape[0]

    def run():
        engine = group.engine(shape, build_model("cuda", torch.float32, cpu_model), tok,
                              batch_size=P23_PARITY_ROWS * d, dtype=torch.float32,
                              decode_kernel=True)
        with engine:
            coco = engine_tokens(engine, *inputs["coco"], P23_PARITY_ROWS * d)
            vqa = engine_tokens(engine, *inputs["vqa"], P23_PARITY_PAIRS * d,
                                inputs["vqa_generate"](engine))
        return coco, vqa, engine

    t0 = time.perf_counter()
    (coco, vqa, engine), peaks, launches = mesh_run(group, run)
    for label, got, ref in (("COCO", coco, want[0]), ("VQA S=1201", vqa, want[1])):
        differ = [i for i in range(len(ref)) if not np.array_equal(got[i], ref[i])]
        check(not differ, "mesh {} f32 {}: rows {} differ from one card's: {} vs {}".format(
            list(shape), label, differ, [got[i].tolist() for i in differ[:2]],
            [ref[i].tolist() for i in differ[:2]]))
    check(engine.group_mismatches == 0, "mesh {}: {} sequence elements differ within a model "
          "group".format(list(shape), engine.group_mismatches))
    check(launches[0] > 0 and launches[1] > 0, "mesh {} f32: launches {}".format(list(shape),
                                                                                 launches))
    log("mesh {} f32 (GIT_LARGE_COCO widths, 2 encoder blocks, 1 decoder layer, attention x10; "
        "kernel 1 on, kernel 2 forced on at S=1201): {} COCO rows and {} VQA pairs (30x40 grid, "
        "[CLS]+13 tokens) give one card's tokens ({} and {} distinct), every model group's ranks "
        "equal; launches over every rank decode_attention {} flash_attention {}; {:.2f} s [{}]".format(
            list(shape), len(coco), len(vqa), len({tuple(r) for r in coco.tolist()}),
            len({tuple(r) for r in vqa.tolist()}), launches[0], launches[1],
            time.perf_counter() - t0, card))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def p23_parity_inputs(seed, tok):
    """(a)'s inputs: 16 COCO images and 8 VQA pairs at 420x560 (a 30x40
    grid, S=1201) with the long question; the VQA search settings as
    generate kwargs (the fused attention forced on in f32)."""
    import numpy as np

    from gitax_torch.tokenization import encode_prefix

    rng = np.random.RandomState(seed + 23)
    coco = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(2 * P23_PARITY_ROWS)]
    vqa = [rng.randint(0, 256, (420, 560, 3)).astype(np.uint8) for _ in range(2 * P23_PARITY_PAIRS)]
    prefix = encode_prefix(tok, VQA_QUESTIONS[1], 40)
    return {"coco": (coco, [[tok.cls_token_id]] * len(coco)),
            "vqa": (vqa, [prefix] * len(vqa)),
            "vqa_generate": lambda engine: dict(beam=engine.beam_for(len(prefix)),
                                                decode_kernel=True, flash=True)}


def p23_one_card(cpu_model, tok, inputs):
    """One card's tokens for (a)'s inputs, in device batches of one data
    rank's rows."""
    import torch

    from gitax_torch.runtime.engine import CaptionEngine

    engine = CaptionEngine(build_model("cuda", torch.float32, cpu_model), tok,
                           batch_size=P23_PARITY_ROWS, dtype=torch.float32, decode_kernel=True)
    with engine:
        out = (engine_tokens(engine, *inputs["coco"], P23_PARITY_ROWS),
               engine_tokens(engine, *inputs["vqa"], P23_PARITY_PAIRS,
                             inputs["vqa_generate"](engine)))
    del engine
    torch.cuda.empty_cache()
    return out


def p23_rate(card, group, shape, cpu_model, tok, items, prefixes, label, one_card):
    """(b): bf16 + int8 at P23_ROWS rows a data rank on a `shape` mesh:
    a warm-up batch, then the timed batches (host clock to the last
    sequence on the host); the share of sequences equal to one card's
    (`one_card`: (tokens, items a second)); each rank's peak memory; the
    launches over every rank.  Returns (launches, the engine's rate)."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig

    d = shape[0]
    rows = P23_ROWS * d

    def run():
        engine = group.engine(shape, build_model("cuda", torch.bfloat16, cpu_model), tok,
                              batch_size=rows, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                              dtype=torch.bfloat16, int8=True, fast_prefill=True,
                              decode_kernel=True)
        with engine:
            engine_tokens(engine, items[:rows], prefixes[:rows], rows)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seqs = engine_tokens(engine, items, prefixes, rows)
            seconds = time.perf_counter() - t0
            vocab = None
            if label == "COCO":
                # kernel 3 on the path: one global batch of 32 through
                # generate(vocab_kernel=True), R = 4 x 32 / d rows a rank
                vocab = engine_tokens(engine, items[:32], prefixes[:32], 32, dict(
                    beam=engine.beam_for(1), fast_prefill=True, decode_kernel=True,
                    vocab_kernel=True))
        return seqs, seconds, vocab, engine

    (seqs, seconds, vocab, engine), peaks, launches = mesh_run(group, run)
    want, one_rate = one_card
    same = np.mean([np.array_equal(a, b) for a, b in zip(seqs, want)])
    check(engine.group_mismatches == 0, "mesh {} {}: {} sequence elements differ within a model "
          "group".format(list(shape), label, engine.group_mismatches))
    rate = len(items) / seconds
    log("mesh {} {} bf16+int8 (beam 4, {} rows a data rank): {:.2f} {}/s over {} after a warm-up "
        "batch, one card {:.2f} in this call; {:.1%} of the sequences equal one card's (drift: "
        "{}); peak memory a rank {} MiB; launches over every rank, warm-up included: "
        "decode_attention {} flash_attention {} vocab_topk {} [{}; {}]".format(
            list(shape), label, P23_ROWS, rate, "images" if label == "COCO" else "pairs",
            len(items), one_rate, same, "tensor parallelism orders the bf16 sums otherwise"
            if shape[1] > 1 else "a data rank runs one card's batch", ["%.1f" % p for p in peaks],
            *launches, card, mesh_layout(group.world, torch.cuda.device_count())[1]))
    if vocab is not None:
        check(launches[2] > 0, "vocab_topk not launched on the mesh")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rate


def p23_one_card_rate(cpu_model, tok, items, prefixes):
    """One card's sequences and rate for (b)'s items: the same settings,
    batches of P23_ROWS, a warm-up batch first."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.runtime.engine import CaptionEngine

    engine = CaptionEngine(build_model("cuda", torch.bfloat16, cpu_model), tok,
                           batch_size=P23_ROWS, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                           dtype=torch.bfloat16, int8=True, fast_prefill=True, decode_kernel=True)
    with engine:
        engine_tokens(engine, items[:P23_ROWS], prefixes[:P23_ROWS], P23_ROWS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqs = engine_tokens(engine, items, prefixes, P23_ROWS)
        rate = len(items) / (time.perf_counter() - t0)
    del engine
    torch.cuda.empty_cache()
    return seqs, rate


def p23_cli(card, group, work, sharp, share, tsv_rate):
    """(c) the CLI: `python -m gitax_torch.inference -p "{..., 'mesh_shape':
    2}"` on phase 14's TSV and checkpoint (bf16, int8, batch 64: 32 rows
    a data rank), every row checked by name; then, in `sharp`, a 16-row
    f32 TSV whose bytes equal the one-card CLI's at batch 8 (a data
    rank's batch of 4 is one card's; the one-card run precedes the
    group).  Returns both runs' launches."""
    from gitax_torch import common, inference
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer

    kwargs = dict(image_tsv="coco.img.tsv", model_name="GIT_LARGE_COCO", question_tsv=None,
                  out_tsv="coco.mesh.tsv", batch_size=2 * P23_ROWS, dtype="bfloat16", int8=True,
                  mesh_shape=2, share_card=share)
    argv = ["-p", "{{'type': 'test_git_inference_single_tsv', 'image_tsv': 'coco.img.tsv', "
                  "'model_name': 'GIT_LARGE_COCO', 'question_tsv': null, 'out_tsv': "
                  "'coco.mesh.tsv', 'batch_size': {}, 'dtype': 'bfloat16', 'int8': true, "
                  "'mesh_shape': 2, 'share_card': {}}}".format(2 * P23_ROWS, share)]
    own = ((lambda: common.dispatch_main(vars(inference), argv)) if have_yaml()
           else (lambda: inference.test_git_inference_single_tsv(**kwargs)))
    loop = Captured(CaptionEngine, "run_caption_tsv")
    decodes = Captured(BertTokenizer, "decode")
    try:
        _, peaks, launches = mesh_run(group, lambda: group.call(
            "gitax_torch.inference", "test_git_inference_single_tsv", work, kwargs, own))
    finally:
        loop.remove()
        decodes.remove()
    from gitax_torch.io.tsv import TSVFile

    keys = [TSVFile(os.path.join(work, "coco.img.tsv")).get_key(i) for i in range(COCO_TSV_ROWS)]
    empty = check_caption_rows("mesh coco tsv", os.path.join(work, "coco.mesh.tsv"), keys, decodes)
    check(launches[0] > 0, "mesh coco tsv: decode_attention not launched")
    log("mesh coco tsv: {} rows through `python -m gitax_torch.inference -p` with mesh_shape 2 "
        "by {} (bf16, int8, batch {}): every row checked, keys in order, {} empty; the loop "
        "{:.2f} images/s beside one card's {:.2f} (phase 14); launches over every rank "
        "decode_attention {} flash_attention {}; peak memory a rank {} MiB [{}]".format(
            COCO_TSV_ROWS, "-p" if have_yaml() else "a direct call", 2 * P23_ROWS, len(empty),
            COCO_TSV_ROWS / loop.seconds[0], tsv_rate, launches[0], launches[1],
            ["%.1f" % p for p in peaks], card))
    small = dict(image_tsv="small.img.tsv", model_name="GIT_LARGE_COCO", question_tsv=None,
                 out_tsv="small.mesh.tsv", batch_size=8, dtype="float32", mesh_shape=[2, 1],
                 share_card=share)
    _, _, small_launches = mesh_run(group, lambda: group.call(
        "gitax_torch.inference", "test_git_inference_single_tsv", sharp, small))
    with open(os.path.join(sharp, "small.one.tsv"), "rb") as a, \
            open(os.path.join(sharp, "small.mesh.tsv"), "rb") as b:
        one, mesh = a.read(), b.read()
    check(one == mesh, "mesh f32 TSV differs from the one-card CLI's")
    log("mesh f32 tsv (attention and visual projection x10): {} rows through "
        "test_git_inference_single_tsv(mesh_shape=[2, 1], batch 8) = the one-card CLI's at batch "
        "4, byte for byte ({} bytes, {} distinct captions)".format(
            P23_TSV_ROWS, len(mesh), len({r.split(b"\t")[1] for r in mesh.splitlines()})))
    return [a + b for a, b in zip(launches, small_launches)]


def p23_sharp(work, coco):
    """(c)'s f32 working directory: phase 5's weights with the decoder's
    attention and the visual projection x10 (phase 16's, so that outputs
    depend on the image) as output/GIT_LARGE_COCO/snapshot/model.pt, and
    the first P23_TSV_ROWS rows of phase 14's TSV."""
    import copy

    import torch

    from gitax_torch.io.tsv import TSVFile, tsv_writer

    sharp = os.path.join(work, "sharp")
    snap = os.path.join(sharp, "output", "GIT_LARGE_COCO", "snapshot")
    os.makedirs(snap)
    torch.save({"model": sharpen_(copy.deepcopy(coco)).state_dict()},
               os.path.join(snap, "model.pt"))
    src = TSVFile(os.path.join(work, "coco.img.tsv"))
    tsv_writer((src[i] for i in range(P23_TSV_ROWS)), os.path.join(sharp, "small.img.tsv"))
    return sharp


def p23_small_one_card(sharp):
    """The one-card CLI on (c)'s 16-row f32 TSV at batch 4 (before the
    group exists: under a group the CLI would shard the rows)."""
    from gitax_torch import inference

    cwd = os.getcwd()
    os.chdir(sharp)
    try:
        inference.test_git_inference_single_tsv("small.img.tsv", "GIT_LARGE_COCO", None,
                                                "small.one.tsv", batch_size=4, dtype="float32")
    finally:
        os.chdir(cwd)


def p23_serving(card, group, work, sharp, share, images, serve_rate):
    """(c) serving: `build_serving_stack(mesh_shape=2)`.  f32 on `sharp`'s
    checkpoint: P23_REQUESTS requests one at a time (a device batch of 1,
    padded to 2 by the mesh), each reply equal to one card's
    generate_batch at batch 1 on rank 0's (whole) model; /stats counts
    the padding.  bf16 + int8 on phase 14's checkpoint after warm():
    LOAD_CLIENTS closed-loop clients for P23_LOAD_SECONDS.  Returns the
    launches over every rank."""
    import base64

    import numpy as np
    import torch

    from gitax_torch.io.image import image_from_base64
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.runtime.serving import DynamicBatcher

    payloads = [base64.b64encode(png_bytes(a)).decode() for a in images[:LOAD_CLIENTS]]
    total = [0, 0, 0]

    def stack(dtype, int8):
        return group.call("gitax_torch.serve", "build_serving_stack",
                          work if int8 else sharp, dict(
            model_name="GIT_LARGE_COCO", batch_size=32, dtype=dtype, int8=int8, mesh_shape=2,
            share_card=share))

    def f32_replies():
        engine, batcher = stack("float32", False)
        batcher.close()
        batcher = DynamicBatcher(engine, max_wait_ms=4.0, buckets=(1, 2))
        try:
            got = [batcher.caption(p, timeout=600) for p in payloads[:P23_REQUESTS]]
            snap = batcher.snapshot()
            one = CaptionEngine(engine.model, engine.tokenizer, batch_size=1,
                                dtype=torch.float32, transform=engine.transform)
            want = [one.generate_batch([np.asarray(engine.transform(image_from_base64(p)),
                                                   np.float32)], [[101]])[0]
                    for p in payloads[:P23_REQUESTS]]
            one.close()
        finally:
            batcher.close()
            engine.close()
        return got, want, snap

    (got, want, snap), _, launches = mesh_run(group, f32_replies)
    total = [a + b for a, b in zip(total, launches)]
    check(got == want, "mesh serving f32: replies {} vs one card's {}".format(got, want))
    check(snap["batch_size_hist"] == {2: P23_REQUESTS} and snap["padded_slots"] == P23_REQUESTS,
          "mesh serving /stats: {}".format(snap))
    log("mesh serving f32 (attention and visual projection x10): {} requests one at a time "
        "through build_serving_stack(mesh_shape=2): "
        "each reply equals one card's generate_batch at batch 1 ({} distinct); /stats batch-size "
        "histogram {} and {} padded slots (the mesh's padding)".format(
            P23_REQUESTS, len(set(got)), snap["batch_size_hist"], snap["padded_slots"]))
    gc.collect()

    def load():
        engine, batcher = stack("bfloat16", True)
        try:
            t0 = time.perf_counter()
            batcher.warm()
            warm_s = time.perf_counter() - t0
            with Served(batcher) as srv:
                bodies = [json.dumps({"image": p}).encode() for p in payloads]
                lat, bad, sent, load_s = closed_loop(srv.base, bodies, P23_LOAD_SECONDS)
                _, stats = http_get(srv.base, "/stats")
        finally:
            batcher.close()
            engine.close()
        return warm_s, lat, bad, sent, load_s, stats

    (warm_s, lat, bad, sent, load_s, stats), peaks, launches = mesh_run(group, load)
    total = [a + b for a, b in zip(total, launches)]
    check(not bad and stats["errors"] == 0, "mesh serving errors: clients {} stats {}".format(
        sorted(set(bad)), stats["errors"]))
    check(stats["requests"] == sent, "mesh /stats count {} requests, {} sent".format(
        stats["requests"], sent))
    lat = np.sort(np.asarray(lat)) * 1e3
    log("mesh serving bf16+int8 (build_serving_stack(mesh_shape=2), batch 32): warm() {:.1f} s; "
        "{} closed-loop clients for {:.1f} s: {} requests, {:.2f} requests/s, latency p50 {:.1f} "
        "ms p99 {:.1f} ms (one card, phase 18: {:.2f} requests/s, p99 {:.1f} ms); /stats batches "
        "{} histogram {} padded slots {}; peak memory a rank {} MiB; launches over every rank "
        "decode_attention {} [{}; {}]".format(
            warm_s, LOAD_CLIENTS, load_s, sent, sent / load_s, np.percentile(lat, 50),
            np.percentile(lat, 99), serve_rate[0], serve_rate[1], stats["batches"],
            dict(sorted((int(k), v) for k, v in stats["batch_size_hist"].items())),
            stats["padded_slots"], ["%.1f" % p for p in peaks], launches[0], card,
            mesh_layout(group.world, torch.cuda.device_count())[1]))
    return total


def phase_mesh_infer(card, coco, vqa, images, work, seed, rates, w8a8_want):
    """23. Inference on a mesh, the port's entry points on data x model
    ranks: this process is rank 0 and ranks 1.. are spawned processes that
    import gitax_torch only, NCCL a card a rank where the machine has a
    card for each, else sharing card 0 over gloo (a rehearsal: no scaling
    figure).  The kernels at a rank's shapes first; (a) f32 parity at
    GIT_LARGE_COCO's widths, cut depth, on [2, 1], [1, 2] and [2, 2]
    against one card, with a VQA grid of S=1201 (kernel 2 at H 8 and 6);
    (b) bf16 + int8 at full size: the COCO engine on DP = cards (2 on one
    card) beside one card, with kernel 3 on one batch, and VQA on [1, 2],
    with each rank's peak memory and the drift from one card; (c) the
    CLI's TSV loop and the server with mesh_shape.  Also the cut model
    w8a8 in f32 on [1, 2] against one card's w8a8 tokens (`w8a8_want`),
    and (c)'s f32 TSV on 2 hosts x mesh_shape 2.  Returns the three
    kernels' launches over every rank of the mesh runs, the per-rank
    kernel rows, and rank 0's int8 launches."""
    import numpy as np
    import torch

    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab, encode_prefix

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    dp = 4 if cards >= 4 else 2
    kernel_rows, _ = check_rank_kernels(card)
    launches = [0, 0, 0]
    int8 = [0, 0]

    def add(x):
        for i in range(3):
            launches[i] += x[i]

    tok = BertTokenizer(build_tiny_vocab(VQA_WORDS))
    parity_model = p23_parity_model(seed)
    inputs = p23_parity_inputs(seed, tok)
    want = p23_one_card(parity_model, tok, inputs)
    coco_tok = BertTokenizer(build_tiny_vocab())
    rng = np.random.RandomState(seed + 230)
    coco_items = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
                  for _ in range(2 * P23_ROWS * dp)]
    coco_pref = [[coco_tok.cls_token_id]] * len(coco_items)
    coco_one = p23_one_card_rate(coco, coco_tok, coco_items, coco_pref)
    vqa_items = [rng.randint(0, 256, (420, 560, 3)).astype(np.uint8) for _ in range(P23_ROWS)]
    vqa_pref = [encode_prefix(tok, VQA_QUESTIONS[1], 40)] * len(vqa_items)
    vqa_one = p23_one_card_rate(vqa, tok, vqa_items, vqa_pref)
    samp_want = p32_one_card(parity_model, tok, inputs, seed)
    sharp = p23_sharp(work, coco)
    p23_small_one_card(sharp)
    gc.collect()
    torch.cuda.empty_cache()

    for world in (2, 4):
        share, label = mesh_layout(world, cards)
        t0 = time.perf_counter()
        group = InferGroup(world, share)
        log("mesh: the {}-rank group ({}) up in {:.1f} s".format(world, label,
                                                                 time.perf_counter() - t0))
        ok = False
        try:
            for shape in ([(2, 1), (1, 2)] if world == 2 else [(2, 2)]):
                add(p23_parity(card, group, shape, parity_model, tok, inputs, want))
            if world == dp:
                got, _ = p23_rate(card, group, (dp, 1), coco, coco_tok, coco_items,
                                          coco_pref, "COCO", coco_one)
                add(got)
            if world == 2:
                got, _ = p23_rate(card, group, (1, 2), vqa, tok, vqa_items, vqa_pref, "VQA",
                                  vqa_one)
                add(got)
                add(p32_sampling(card, group, parity_model, tok, inputs, seed, samp_want, coco,
                                 coco_tok, coco_items, coco_pref))
                add(p23_cli(card, group, work, sharp, share, rates["coco_tsv"]))
                add(p23_serving(card, group, work, sharp, share, images, rates["serving"]))
                int8 = list(p23_w8a8(card, group, work, seed, w8a8_want))
            else:
                add(p23_hosts(card, group, sharp, share))
            ok = True
        finally:
            group.close(ok)
        log("mesh: the {}-rank group's runs {:.1f} s".format(world, time.perf_counter() - t0))
    check(all(n > 0 for n in launches), "phase 23: a kernel was not launched: {}".format(launches))
    log("phase 23 (inference on a mesh) {:.1f} s; launches over every rank of the mesh runs: "
        "decode_attention {} flash_attention {} vocab_topk {}".format(
            time.perf_counter() - t_phase, *launches))
    return launches, kernel_rows, int8

# ---------------------------------------------------------------------------
# 24-29: the doctor, the w8a8 encoder, the reference checkpoint, row shards
# over hosts and the trace
# ---------------------------------------------------------------------------

# the encoder's four GEMMs (K, N) at GIT_LARGE's width 1024, and the rows
# of a batch of 32 at COCO's S=257 and VQA's 30x40 grid (S=1201)
W8A8_GEMMS = (("qkv", 1024, 3072), ("out_proj", 1024, 1024), ("c_fc", 1024, 4096),
              ("c_proj", 4096, 1024))
W8A8_ROWS = (("COCO", 32 * 257), ("VQA", 32 * 1201))
# the H100 SXM's dense int8 tensor-core rate
INT8_OPS = 1979e12
W8A8_REPS = 3  # timed encodes after one warm-up
W8A8_PARITY_ROWS = 8


def phase_doctor(card):
    """24. `python -m gitax_torch.doctor --json` in a child process: exit 0,
    every required check passed; its native probe (jpeglib.h / -ljpeg,
    nvjpeg.h / -lnvjpeg through the toolkit's nvcc) on a line of its
    own."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gitax_torch.doctor", "--json"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, "the doctor exited {}: {}{}".format(r.returncode, r.stdout[-3000:],
                                                                r.stderr[-3000:]))
    report = json.loads(r.stdout.strip().splitlines()[-1])
    checks = {c["name"]: c for c in report["checks"]}
    check(report["ok"] and all(c["ok"] for c in report["checks"] if c["required"]),
          "the doctor: {}".format(report))
    log("doctor: native probe: {}".format(checks["native"]["detail"]))
    log("doctor: {} ({:.1f} s) [{}]".format("; ".join(
        "{} {} ({})".format(n, "ok" if c["ok"] else "warn", c["detail"][:160])
        for n, c in checks.items() if n != "native"), time.perf_counter() - t0, card))


def w8a8_activations(g, m, k, dtype):
    """Encoder-like rows [m, k]: N(0, 1) with one outlier of 20 in every
    7th row, in `dtype`."""
    import torch

    x = torch.randn(m, k, generator=g, device="cuda")
    x[::7, 3] = 20.0
    return x.to(dtype)


def check_int8_kernels():
    """The w8a8 kernels against their plain versions at COCO's and VQA's
    encoder shapes: the codes and row scales bit for bit (each row's own
    amax, and an amax from outside as under tensor parallelism), in bf16
    and f32; torch._int_mm equal to the exact int32 product; the epilogue
    bit for bit with its bias.  Returns the largest |kernel - plain|
    (0.0)."""
    import torch

    from gitax_torch.ops import int8_dynamic as i8

    g = torch.Generator(device="cuda").manual_seed(24)
    worst = 0.0
    for label, m in W8A8_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            xs = {k: w8a8_activations(g, m, k, dtype) for k in (1024, 4096)}
            for k, x in xs.items():
                for amax in (None, i8.row_amax(x) * 1.5):
                    q, s = i8.quantize_rows_cuda(x, amax)
                    q0, s0 = i8.quantize_rows_reference(x, amax)
                    torch.cuda.synchronize()
                    check(torch.equal(q, q0) and torch.equal(s, s0),
                          "int8 quantize_rows {} M={} K={} {}{}: {} codes and {} scales "
                          "differ".format(label, m, k, dtype, " (amax given)" if amax is not None
                                          else "", int((q != q0).sum()), int((s != s0).sum())))
            for name, k, n in W8A8_GEMMS:
                q, s = i8.quantize_rows_reference(xs[k])
                w = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                                  dtype=torch.int8).t()
                y = i8.int_mm(q, w)
                if dtype == torch.bfloat16:  # the product does not see the activation dtype
                    y0 = i8.int_mm_reference(q, w)
                    check(torch.equal(y, y0), "torch._int_mm {} {} M={}: {} elements differ from "
                          "the exact product".format(label, name, m, int((y != y0).sum())))
                ws = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
                bias = (torch.randn(n, generator=g, device="cuda") * 0.1).to(dtype)
                for b in (bias, None):
                    out = i8.scale_rows_cuda(y, s, ws, b, dtype)
                    ref = i8.scale_rows_reference(y, s, ws, b, dtype)
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    worst = max(worst, err)
                    check(torch.equal(out, ref), "int8 scale_rows {} {} M={} N={} {}{}: max "
                          "|kernel - plain| {:.3e}".format(label, name, m, n, dtype,
                                                           "" if b is None else " + bias", err))
            del xs
            torch.cuda.empty_cache()
    log("int8 kernels: quantize_rows (codes, row scales; the row's amax and one given) and "
        "scale_rows (with and without bias) equal their plain versions bit for bit, and "
        "torch._int_mm the exact int32 product, at COCO's M={} and VQA's M={}, K 1024/4096, "
        "N 1024/3072/4096, bf16 and f32".format(W8A8_ROWS[0][1], W8A8_ROWS[1][1]))
    return worst


def w8a8_bounds(m, k, n):
    """(quant, _int_mm, epilogue, bf16 linear) bounds at bf16 activations:
    each a (ms, 'bytes' | 'operations')."""
    return (bound(m * k * 2 + m * k + m * 4, 0, INT8_OPS),
            bound(m * k + k * n + m * n * 4, 2 * m * k * n, INT8_OPS),
            bound(m * n * 4 + m * 4 + n * 4 + n * 2 + m * n * 2, 0, INT8_OPS),
            bound(m * k * 2 + k * n * 2 + n * 2 + m * n * 2, 2 * m * k * n, BF16_FLOPS))


def time_int8(card):
    """The w8a8 product's split at each encoder GEMM, bf16, COCO's and
    VQA's rows: quantize_rows, torch._int_mm and scale_rows (CUDA events)
    beside their bounds, against the bf16 F.linear of the same GEMM (the
    encoder's path without w8a8).  Then the kernels line's entries, at VQA's
    rows: quantize_rows on c_proj's input (K=4096) and scale_rows on c_fc's
    output (N=4096), device time from the profiler, the plain version in
    turns, the bounds; no single PyTorch call computes either function."""
    import torch
    import torch.nn.functional as F

    from gitax_torch.ops import int8_dynamic as i8

    g = torch.Generator(device="cuda").manual_seed(25)
    split = {}
    for label, m in W8A8_ROWS:
        for name, k, n in W8A8_GEMMS:
            x = w8a8_activations(g, m, k, torch.bfloat16)
            w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8).t()
            wf = (torch.randn(n, k, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
            ws = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
            bias = (torch.randn(n, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
            q, s = i8.quantize_rows_cuda(x)
            y = i8.int_mm(q, w)
            t = (cuda_time_ms(lambda: i8.quantize_rows_cuda(x), 20, 3),
                 cuda_time_ms(lambda: i8.int_mm(q, w), 20, 3),
                 cuda_time_ms(lambda: i8.scale_rows_cuda(y, s, ws, bias, torch.bfloat16), 20, 3),
                 cuda_time_ms(lambda: F.linear(x, wf, bias), 20, 3))
            b = w8a8_bounds(m, k, n)
            split[(label, name)] = t
            log("w8a8 split {} {:8s} M={} K={} N={} bf16: quantize_rows {:.4f} ms (bound {:.4f}, "
                "{}) + _int_mm {:.4f} (bound {:.4f}, {}) + scale_rows {:.4f} (bound {:.4f}, {}) = "
                "{:.4f} ms against F.linear bf16 {:.4f} ms (bound {:.4f}, {}) (events) [{}]".format(
                    label, name, m, k, n, t[0], b[0][0], b[0][1], t[1], b[1][0], b[1][1], t[2],
                    b[2][0], b[2][1], sum(t[:3]), t[3], b[3][0], b[3][1], card))
            del x, w, wf, q, y
    torch.cuda.empty_cache()
    for label, _ in W8A8_ROWS:
        w8 = sum(sum(split[(label, name)][:3]) for name, _, _ in W8A8_GEMMS)
        bf = sum(split[(label, name)][3] for name, _, _ in W8A8_GEMMS)
        log("w8a8 split {}: one block's four GEMMs {:.4f} ms w8a8 against {:.4f} ms bf16 "
            "F.linear ({:.2f}x) [{}]".format(label, w8, bf, w8 / bf, card))

    m = W8A8_ROWS[1][1]
    out = {}
    x = w8a8_activations(g, m, 4096, torch.bfloat16)
    plain_ms, _, _ = in_turns(lambda: i8.quantize_rows_reference(x),
                              lambda: i8.quantize_rows_cuda(x), 5, 20, 3)
    ms = device_ms(lambda: i8.quantize_rows_cuda(x), 20, "int8_quantize_rows")
    b = w8a8_bounds(m, 4096, 1024)[0]
    out["int8_quantize_rows"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                                     library_ms=None)
    log("int8 quantize_rows time, bf16 M={} K=4096 (VQA c_proj's input): {:.4f} ms on the device "
        "(profiler), plain {:.4f} ms, bound {:.4f} ms ({}), {:.1%} of it [{}]".format(
            m, ms, plain_ms, b[0], b[1], b[0] / ms, card))
    del x
    q = torch.randint(-127, 128, (m, 1024), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (4096, 1024), generator=g, device="cuda", dtype=torch.int8).t()
    y = i8.int_mm(q, w)
    s = torch.rand(m, generator=g, device="cuda") * 0.1
    ws = torch.rand(4096, generator=g, device="cuda") * 1e-3
    bias = (torch.randn(4096, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    plain_ms, _, _ = in_turns(lambda: i8.scale_rows_reference(y, s, ws, bias, torch.bfloat16),
                              lambda: i8.scale_rows_cuda(y, s, ws, bias, torch.bfloat16), 5, 20, 3)
    ms = device_ms(lambda: i8.scale_rows_cuda(y, s, ws, bias, torch.bfloat16), 20,
                   "int8_scale_rows")
    b = w8a8_bounds(m, 1024, 4096)[2]
    out["int8_scale_rows"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                                  library_ms=None)
    log("int8 scale_rows time, bf16 M={} N=4096 (VQA c_fc's output, + bias): {:.4f} ms on the "
        "device (profiler), plain {:.4f} ms, bound {:.4f} ms ({}), {:.1%} of it [{}]".format(
            m, ms, plain_ms, b[0], b[1], b[0] / ms, card))
    del q, w, y
    torch.cuda.empty_cache()
    return out


def phase_int8_kernels(card):
    """25. The w8a8 kernels: checked against their plain versions, the
    product split at each encoder GEMM, the kernels line's times."""
    t0 = time.perf_counter()
    worst = check_int8_kernels()
    out = time_int8(card)
    for v in out.values():
        v["max_abs_err"] = worst
    log("phase 25 (the w8a8 kernels) {:.1f} s".format(time.perf_counter() - t0))
    return out


def int8_launches():
    from gitax_torch.ops import int8_dynamic as i8

    return i8.quantize_rows.launches, i8.scale_rows.launches


def reset_int8_launches():
    from gitax_torch.ops import int8_dynamic as i8

    i8.quantize_rows.launches = 0
    i8.scale_rows.launches = 0


def encode_ms(model, x, dtype, reps=W8A8_REPS):
    """The device span of `encode_images` (CUDA events), mean of `reps`
    after a warm-up; the last output."""
    import torch

    out = model.encode_images(x, dtype)
    spans = DeviceSpans(model, "encode_images")
    for _ in range(reps):
        out = model.encode_images(x, dtype)
    torch.cuda.synchronize()
    ms = spans.ms()
    spans.remove()
    return sum(ms) / len(ms), out


def phase_w8a8_path(card, coco, vqa, images, seed):
    """26. The w8a8 encoder on the path (`quantize_git_model_(model,
    encoder=True)`): GIT_LARGE_VQAv2 at 30x40 (S=1201) and GIT_LARGE_COCO
    (S=257), B=32, bf16 (the decoder weight-only int8, as the engine's
    int8): encode ms, bf16 against w8a8 (device events), launches = 4 GEMMs
    x 24 blocks a batch; COCO's sequences through the engine's search
    against the bf16 weight-only-int8 run's (the drift); the cut model
    (2 encoder blocks, 1 decoder layer) in f32: the card's w8a8 tokens
    equal the CPU plain path's (the plain decode step on both sides).
    Returns the int8 kernels' launches."""
    import copy

    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops.quant import quantize_git_model_
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    t_phase = time.perf_counter()
    launches = [0, 0]
    rng = np.random.RandomState(seed + 26)
    inputs = {"VQA": (vqa, torch.from_numpy(rng.randn(32, 420, 560, 3).astype(np.float32))),
              "COCO": (coco, normalized(images[:32], torch.float32).cpu())}
    blocks = coco.cfg.encoder.layers
    for label, (cpu_model, x_host) in inputs.items():
        torch.cuda.reset_peak_memory_stats()
        x = x_host.cuda().to(torch.bfloat16)
        model = build_model("cuda", torch.bfloat16, cpu_model)
        bf16_ms, ref = encode_ms(model, x, torch.bfloat16)
        if label == "VQA":  # where an encode's device time goes, before and after
            profile_batch("w8a8 path VQA bf16 encode", card,
                          lambda: model.encode_images(x, torch.bfloat16))
        t0 = time.perf_counter()
        quantize_git_model_(model, encoder=True)
        q_s = time.perf_counter() - t0
        reset_int8_launches()
        w8_ms, got = encode_ms(model, x, torch.bfloat16)
        n = int8_launches()
        if label == "VQA":
            profile_batch("w8a8 path VQA w8a8 encode", card,
                          lambda: model.encode_images(x, torch.bfloat16))
        check(n == (4 * blocks * (W8A8_REPS + 1),) * 2, "w8a8 {} encode: int8 launches {} != 4 x "
              "{} blocks x {} encodes".format(label, n, blocks, W8A8_REPS + 1))
        launches = [a + b for a, b in zip(launches, n)]
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        log("w8a8 path {}: B=32 S={} bf16 encode {:.2f} ms, w8a8 {:.2f} ms ({:.2f}x; device "
            "events, mean of {}); the encoder's output within {:.3e} relative L2 of bf16's; "
            "quantize_git_model_(encoder=True) {:.1f} s; launches quantize_rows {} scale_rows {} "
            "= 4 x {} x {} [{}]".format(label, x.shape[1] * x.shape[2] // 14 ** 2 + 1, bf16_ms,
                                        w8_ms, w8_ms / bf16_ms, W8A8_REPS, rel, q_s, n[0], n[1],
                                        blocks, W8A8_REPS + 1, card))
        peak_memory("w8a8 path " + label, card)
        del model, x, ref, got
        torch.cuda.empty_cache()

    # COCO drift: the engine's search, w8a8 + int8 against int8 alone
    tok = BertTokenizer(build_tiny_vocab())
    prefixes = [[tok.cls_token_id]] * 32
    seqs = {}
    for label, encoder in (("int8", False), ("w8a8", True)):
        model = quantize_git_model_(build_model("cuda", torch.bfloat16, coco), encoder=encoder)
        engine = CaptionEngine(model, tok, batch_size=32,
                               beam=BeamSearchConfig(num_beams=4, max_steps=24),
                               dtype=torch.bfloat16, fast_prefill=True, decode_kernel=True)
        reset_int8_launches()
        handle = engine.dispatch(images[:32], prefixes)
        seqs[label] = torch.cat([t.cpu() for _, bucket in handle[1] for t in bucket])
        n = int8_launches()
        check((n[0] > 0) == encoder, "w8a8 drift {}: int8 launches {}".format(label, n))
        launches = [a + b for a, b in zip(launches, n)]
        engine.close()
        del engine, model, handle
        torch.cuda.empty_cache()
    same = sum(bool(torch.equal(a, b)) for a, b in zip(seqs["int8"], seqs["w8a8"]))
    log("w8a8 drift, COCO B=32 bf16 (beam 4, the engine's settings): {} of 32 sequences ({:.1%}) "
        "equal the weight-only int8 run's; {} and {} distinct outputs [{}]".format(
            same, same / 32, len({tuple(r) for r in seqs["int8"].tolist()}),
            len({tuple(r) for r in seqs["w8a8"].tolist()}), card))

    # f32: the cut model's w8a8 tokens, card (kernels) against CPU (plain)
    cut = quantize_git_model_(p23_parity_model(seed), encoder=True)
    x = w8a8_parity_images(seed)
    beam = BeamSearchConfig(num_beams=4, max_steps=24)
    want, _ = cut.generate(x.cpu(), beam=beam)
    card_model = copy.deepcopy(cut).to("cuda")  # the int8 codes and scales as they are
    reset_int8_launches()
    got, _ = card_model.generate(x, beam=beam)
    n = int8_launches()
    launches = [a + b for a, b in zip(launches, n)]
    differ = [i for i in range(len(want)) if not torch.equal(got[i].cpu(), want[i])]
    check(not differ and n[0] > 0, "w8a8 f32: the card's tokens differ from the CPU's in rows {} "
          "(launches {}): {} vs {}".format(differ, n, [got[i].tolist() for i in differ[:2]],
                                           [want[i].tolist() for i in differ[:2]]))
    log("w8a8 f32 (GIT_LARGE_COCO widths, 2 encoder blocks, 1 decoder layer, sharpened): {} "
        "images, the card's tokens (int8 kernels, launches {}) equal the CPU's plain path's ({} "
        "distinct) [{}]".format(W8A8_PARITY_ROWS, n, len({tuple(r) for r in want.tolist()}), card))
    del card_model, cut
    torch.cuda.empty_cache()
    log("phase 26 (w8a8 on the path) {:.1f} s; launches quantize_rows {} scale_rows {}".format(
        time.perf_counter() - t_phase, *launches))
    return launches, got.cpu()


def w8a8_parity_images(seed):
    """W8A8_PARITY_ROWS uint8 224x224 images from the seed, normalised to
    f32 on the card (every rank of phase 23 makes the same)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed + 26)
    return normalized([rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
                       for _ in range(W8A8_PARITY_ROWS)], torch.float32)


def w8a8_mesh_rank(seed):
    """Every rank of phase 23's 2-rank group: the cut model of (a), w8a8
    (quantized whole on the CPU, then split over a [1, 2] mesh of the
    group), f32, searching `w8a8_parity_images`; the tokens on rank 0."""
    import torch
    import torch.distributed as dist

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops.quant import quantize_git_model_
    from gitax_torch.parallel.mesh import make_mesh, shard_for_inference

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(1, 2, device=dev)
    model = shard_for_inference(quantize_git_model_(p23_parity_model(seed), encoder=True).to(dev),
                                mesh)
    seqs, _ = model.generate(w8a8_parity_images(seed),
                             beam=BeamSearchConfig(num_beams=4, max_steps=24))
    return seqs.cpu() if dist.get_rank() == 0 else None


def p23_w8a8(card, group, work, seed, want):
    """(a) w8a8: the cut model on [1, 2], f32, every row-parallel product
    on the row's whole amax (all-reduced over the model group) with its
    int32 partials summed: one card's w8a8 tokens (`want`, phase 26).
    Returns rank 0's int8 launches."""
    t0 = time.perf_counter()
    reset_int8_launches()
    got, peaks, _ = mesh_run(group, lambda: group.call("chip_smoke", "w8a8_mesh_rank", work,
                                                       dict(seed=seed)))
    n = int8_launches()
    differ = [i for i in range(len(want)) if not bool((got[i] == want[i]).all())]
    check(not differ and n[0] > 0, "mesh [1, 2] w8a8 f32: rows {} differ from one card's (rank "
          "0's launches {})".format(differ, n))
    log("mesh [1, 2] w8a8 f32 (the cut model of (a), the encoder's row-parallel products on the "
        "row's all-reduced amax, int32 partials summed): {} images give one card's w8a8 tokens; "
        "rank 0's launches quantize_rows {} scale_rows {}; {:.2f} s [{}]".format(
            len(want), n[0], n[1], time.perf_counter() - t0, card))
    return n


def p23_hosts(card, group, sharp, share):
    """(c) row shards over hosts: (c)'s 16-row f32 TSV through
    test_git_inference_single_tsv(mesh_shape=2) on the 4-rank group, which
    is 2 hosts of a [2, 1] mesh each: each host's rank 0 captions its 8
    rows, host 0 joins the shards; byte-identical to the one-card CLI's.
    Returns the launches over every rank."""
    t0 = time.perf_counter()
    small = dict(image_tsv="small.img.tsv", model_name="GIT_LARGE_COCO", question_tsv=None,
                 out_tsv="small.hosts.tsv", batch_size=8, dtype="float32", mesh_shape=2,
                 share_card=share)
    _, peaks, launches = mesh_run(group, lambda: group.call(
        "gitax_torch.inference", "test_git_inference_single_tsv", sharp, small))
    with open(os.path.join(sharp, "small.one.tsv"), "rb") as a, \
            open(os.path.join(sharp, "small.hosts.tsv"), "rb") as b:
        one, hosts = a.read(), b.read()
    shards = [os.path.join(sharp, "small.hosts.tsv.{}.2.tsv".format(h)) for h in range(2)]
    check(all(os.path.isfile(s) for s in shards), "row shards over hosts: a host's shard is "
          "missing")
    check(one == hosts, "row shards over hosts: the joined f32 TSV differs from the one-card "
          "CLI's")
    log("row shards over hosts: {} rows through test_git_inference_single_tsv(mesh_shape=2) on 4 "
        "ranks = 2 hosts x [2, 1] (rows {} and {}), joined by host 0 = the one-card CLI's TSV, "
        "byte for byte ({} bytes); launches over every rank decode_attention {}; peak memory a "
        "rank {} MiB; {:.2f} s [{}]".format(
            P23_TSV_ROWS, "0-7", "8-15", len(hosts), launches[0], ["%.1f" % p for p in peaks],
            time.perf_counter() - t0, card))
    return launches


def phase_reference_checkpoint(card, cpu_model, work, write_s):
    """27. The reference checkpoint: phase 14 wrote phase 5's model with
    `ckpt.save_reference_checkpoint` (f32 CPU tensors under the
    reference's names), and the CLI loaded it for both its TSVs; here the
    CLI's TSV of the 32 one-colour rows equals, byte for byte, the TSV of
    an engine with the CLI's settings around the in-memory model."""
    import torch

    from gitax_torch import inference
    from gitax_torch.ckpt import load_torch_checkpoint
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.models.git import GitModel
    from gitax_torch.preprocess.transforms import get_image_transform
    from gitax_torch.runtime.engine import CaptionEngine

    t0 = time.perf_counter()
    path = os.path.join(work, "output", "GIT_LARGE_COCO", "snapshot", "model.pt")
    sd = load_torch_checkpoint(path)
    check(sorted(sd) == sorted(cpu_model.state_dict()) and all(
        t.dtype == torch.float32 for t in sd.values()), "the reference checkpoint's names or types")
    param = inference._load_param("GIT_LARGE_COCO")
    model = GitModel(inference.config_from_param(param), device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(cpu_model.state_dict())
    engine = CaptionEngine(model, inference._load_tokenizer(), batch_size=32,
                           beam=BeamSearchConfig(num_beams=4, max_steps=40), dtype=torch.bfloat16,
                           int8=True, transform=get_image_transform(param))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with engine:
            engine.run_caption_tsv("flat.img.tsv", "flat.mem.tsv")
    finally:
        os.chdir(cwd)
    with open(os.path.join(work, "flat.out.tsv"), "rb") as a, \
            open(os.path.join(work, "flat.mem.tsv"), "rb") as b:
        cli, mem = a.read(), b.read()
    check(cli == mem, "the CLI's captions from the reference checkpoint differ from the in-memory "
          "model's")
    log("reference checkpoint: save_reference_checkpoint wrote GIT_LARGE_COCO in {:.2f} s ({:.1f} "
        "MiB, {} tensors, f32); the CLI's {} rows from it = the in-memory model's, byte for byte "
        "(bf16, int8, batch 32); {:.2f} s [{}]".format(
            write_s, os.path.getsize(path) / 2**20, len(sd), FLAT_ROWS,
            time.perf_counter() - t0, card))
    del engine, model, sd
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 30-33: the CLIP towers, the CLIP-loaded encoder, sampling on a tensor-
# parallel model (in phase 23), the native loader
# ---------------------------------------------------------------------------

# CLIP RN50's published widths and its text tower (reference CLIP/clip.py's
# RN50 archive: vision layers (3, 4, 6, 3), width 64, embed 1024, 224 px;
# text width 512, 8 heads, 12 layers, context 77, vocab 49408)
RN50 = dict(layers=(3, 4, 6, 3), width=64, output_dim=1024, heads=32, input_resolution=224)
RN50_TEXT = dict(context_length=77, vocab_size=49408, width=512, heads=8, layers=12)
CLIP_B, CLIP_PARITY_ROWS, CLIP_REPS = 32, 2, 5
# the CLIP-loaded ViT-L/14 resized to 480 px (a 34 x 34 table), run on
# VQA's 420 x 560 inputs (a 30 x 40 grid, S = 1201: the table interpolated)
CLIP_RES, CLIP_HW = 480, (420, 560)
CLIP_CHECK_B = 4  # the kernel held against its plain version on every call


def resnet_flops(cfg, h, w, pooled):
    """Multiply-adds x 2 of `models.resnet.resnet_forward` on one h x w
    image: the convolutions, and the attention pool where pooled."""
    f = 0

    def conv(cin, cout, k, r):
        return 2 * cin * cout * k * k * r[0] * r[1]

    r = (h // 2, w // 2)
    half = cfg.width // 2
    f += conv(3, half, 3, r) + conv(half, half, 3, r) + conv(half, cfg.width, 3, r)
    r = (r[0] // 2, r[1] // 2)
    inplanes = cfg.width
    for gi, n in enumerate(cfg.layers):
        planes = cfg.width * 2 ** gi
        for bi in range(n):
            s = 2 if gi and not bi else 1
            f += conv(inplanes, planes, 1, r) + conv(planes, planes, 3, r)
            out = (r[0] // s, r[1] // s)
            f += conv(planes, 4 * planes, 1, out)
            if s > 1 or inplanes != 4 * planes:
                f += conv(inplanes, 4 * planes, 1, out)
            inplanes, r = 4 * planes, out
    if pooled:
        e, t = cfg.embed_dim, r[0] * r[1] + 1
        f += 2 * e * e + 2 * 2 * t * e * e + 2 * 2 * t * e + 2 * e * cfg.output_dim
    return f


def text_flops(cfg, t, embed):
    """Multiply-adds x 2 of `models.clip.text_forward` on one row of t
    tokens."""
    w = cfg.width
    return cfg.layers * t * (24 * w * w + 4 * t * w) + 2 * w * embed


def clip_tokens(g, n, cfg):
    """n token rows as CLIP's tokenizer lays them out: a random length,
    random ids, the EOT (the highest id) last, zeros after."""
    import torch

    tok = torch.zeros(n, cfg.context_length, dtype=torch.long)
    lengths = torch.randint(5, cfg.context_length + 1, (n,), generator=g)
    for i, n_tok in enumerate(lengths.tolist()):
        tok[i, :n_tok - 1] = torch.randint(1, cfg.vocab_size - 1, (n_tok - 1,), generator=g)
        tok[i, n_tok - 1] = cfg.vocab_size - 1
    return tok


def phase_clip_towers(card, seed):
    """30. CLIP's RN50 at its published widths and its text tower, random
    weights from `seed` (`init_params`): the card's f32 output (both TF32
    switches off) within 1e-4 of its largest magnitude of the port's CPU
    plain path on CLIP_PARITY_ROWS images and token rows, grid, pooled
    and text; the bf16 drift; ms per batch of CLIP_B (CUDA events, mean of
    CLIP_REPS after a warm-up) beside the FLOP bound, f32 and bf16.  The
    convolutions are cuDNN's (gitax's are XLA convolutions: no Pallas
    kernel stands behind them)."""
    import torch

    from gitax_torch.models import clip, resnet

    t0 = time.perf_counter()
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "phase 30 holds f32 with TF32 off")
    cfg = resnet.ResNetConfig(**RN50)
    tcfg = clip.CLIPTextConfig(**RN50_TEXT)
    g = torch.Generator().manual_seed(seed + 30)
    cpu_rn = resnet.ModifiedResNet(cfg, device="cpu").init_params(g)
    cpu_tx = clip.TextTransformer(tcfg, cfg.output_dim, device="cpu").init_params(g)
    images = torch.randn(CLIP_B, cfg.input_resolution, cfg.input_resolution, 3, generator=g)
    tokens = clip_tokens(g, CLIP_B, tcfg)
    n = CLIP_PARITY_ROWS
    with torch.inference_mode():
        want = {"grid": resnet.resnet_forward(cpu_rn, images[:n]),
                "pooled": resnet.resnet_forward(cpu_rn, images[:n], output_grid=False),
                "text": clip.text_forward(cpu_tx, tokens[:n])}
    x, tok = images.cuda(), tokens.cuda()
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        rn = resnet.ModifiedResNet(cfg, device="cuda", dtype=dtype)
        rn.load_state_dict(cpu_rn.state_dict())
        tx = clip.TextTransformer(tcfg, cfg.output_dim, device="cuda", dtype=dtype)
        tx.load_state_dict(cpu_tx.state_dict())
        calls = {"grid": lambda: resnet.resnet_forward(rn, x, dtype),
                 "pooled": lambda: resnet.resnet_forward(rn, x, dtype, output_grid=False),
                 "text": lambda: clip.text_forward(tx, tok, dtype)}
        name = "f32" if dtype == torch.float32 else "bf16"
        peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        with torch.inference_mode():
            for label, fn in calls.items():
                out = fn()[:n].float().cpu()
                check(torch.isfinite(out).all().item() and out.shape == want[label].shape,
                      "CLIP {} {}: shape {} or non-finite".format(label, name, tuple(out.shape)))
                err = ((out - want[label]).abs().max() / want[label].abs().max()).item()
                if dtype == torch.float32:
                    check(err <= 1e-4, "CLIP {} f32 card vs CPU: {} of max|out|".format(label, err))
                ms = cuda_time_ms(fn, CLIP_REPS, warmup=1)
                if label == "text":
                    flops = CLIP_B * text_flops(tcfg, tcfg.context_length, cfg.output_dim)
                    # the embedding rows the tokens gather, not the whole table
                    params = (sum(p.numel() for p in tx.parameters())
                              - tx.token_embedding.weight.numel() + tok.numel() * tcfg.width)
                    io_bytes = tok.numel() * 8 + CLIP_B * cfg.output_dim * dtype.itemsize
                else:
                    flops = CLIP_B * resnet_flops(cfg, cfg.input_resolution, cfg.input_resolution,
                                                  label == "pooled")
                    params = sum(p.numel() for p in rn.parameters())
                    io_bytes = (x.numel() * 4 + CLIP_B * (cfg.output_dim if label == "pooled"
                                                          else 49 * cfg.embed_dim)
                                * dtype.itemsize)
                bound_ms, bound_by = bound(params * dtype.itemsize + io_bytes, flops, peak)
                rows[label, name] = ms
                log("CLIP {} {} B={}: {:.4f} ms per batch (events, mean of {} after a warm-up); "
                    "bound {:.4f} ms ({}: {:.1f} GFLOP), {:.1%} of it; card vs CPU f32 plain "
                    "on {} rows: max|diff| {:.3e} of max|out| ({}) [{}]".format(
                        "RN50 " + label if label != "text" else "RN50 text tower", name, CLIP_B,
                        ms, CLIP_REPS, bound_ms, bound_by, flops / 1e9, bound_ms / ms, n, err,
                        "tol 1e-4" if dtype == torch.float32 else "bf16 drift", card))
        del rn, tx
        torch.cuda.empty_cache()
    log("phase 30 (the CLIP towers) {:.1f} s".format(time.perf_counter() - t0))
    return rows


def clip_archive_state_dict(cpu_model, g):
    """A CLIP ViT-L/14 state dict: GIT_LARGE_COCO's encoder (ViT-L/14 at
    224 px, CLIP's own widths) under `visual.` with a projection to 768,
    and a tiny text tower (width 64, one layer, vocab 1000)."""
    import torch

    from gitax_torch.models import clip

    sd = {"visual." + k: v for k, v in cpu_model.image_encoder.state_dict().items()}
    width = cpu_model.cfg.encoder.width
    sd["visual.proj"] = torch.randn(width, 768, generator=g) * width ** -0.5
    tcfg = clip.CLIPTextConfig(context_length=77, vocab_size=1000, width=64, heads=1, layers=1)
    sd.update(clip.TextTransformer(tcfg, 768, device="cpu").init_params(g).state_dict())
    return sd, tcfg


def phase_clip_encoder(card, cpu_model, work, seed):
    """31. A synthesised ViT-L/14 CLIP archive (GIT_LARGE_COCO's encoder
    weights under `visual.`, a projection, a tiny text tower), written by
    `ckpt.clip_archive.save_clip_archive` into the work dir and removed
    after; `load_image_encoder_from_archive(..., 480, verify='warn')` on
    the card in bf16: its positional table resized to 34 x 34, then GIT's
    grid encode of 420 x 560 inputs (S = 1201, the table interpolated at
    run time, as VQA's) with kernel 2 forced on.  Every one of the
    encoder's kernel-2 calls on CLIP_CHECK_B images held to its plain
    version at `check_flash_case`'s bf16 bounds on the path's own inputs;
    then B=32: the launches (24) counted, ms per batch beside flash=False
    on the same weights, and the two outputs' relative L2 distance.
    Returns the counted kernel-2 launches."""
    import torch

    from gitax_torch.ckpt import clip_archive
    from gitax_torch.models import nn as mnn
    from gitax_torch.models.vit import vit_forward
    from gitax_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed + 31)
    sd, tcfg = clip_archive_state_dict(cpu_model, g)
    path = os.path.join(work, "ViT-L-14.pt")  # the published name: its pin applies
    t1 = time.perf_counter()
    clip_archive.save_clip_archive(path, sd, cpu_model.cfg.encoder.input_resolution,
                                   tcfg.context_length, tcfg.vocab_size)
    write_s, size = time.perf_counter() - t1, os.path.getsize(path)
    t1 = time.perf_counter()
    cfg, vit = clip_archive.load_image_encoder_from_archive(path, CLIP_RES, verify="warn",
                                                            device="cuda", dtype=torch.bfloat16)
    load_s = time.perf_counter() - t1
    os.remove(path)
    check(cfg.grid == CLIP_RES // cfg.patch_size and vit.proj is not None
          and tuple(vit.positional_embedding.shape) == (cfg.num_tokens, cfg.width),
          "the resized encoder: {} {}".format(cfg, tuple(vit.positional_embedding.shape)))
    gh, gw = CLIP_HW[0] // cfg.patch_size, CLIP_HW[1] // cfg.patch_size
    x = torch.randn(CLIP_B, CLIP_HW[0], CLIP_HW[1], 3, generator=g).cuda().to(torch.bfloat16)

    real, errs = mnn.flash_qkv_attention, []

    def held(qkv, h):
        out = real(qkv, h)
        q, k, v = [t.transpose(1, 2) for t in qkv.unflatten(2, (3, h, DH)).unbind(2)]
        o = out.unflatten(2, (h, DH)).transpose(1, 2).float()
        ref32 = fa.attention_reference(q.float(), k.float(), v.float())
        ref = fa.attention_reference(q, k, v).float()
        err, same = (o - ref32).abs().max().item(), (o - ref).abs().max().item()
        atol, same_tol = v.float().abs().max().item() / 128, ref32.abs().max().item() / 64
        check(torch.allclose(o, ref32, atol=atol, rtol=1 / 128) and same <= same_tol,
              "CLIP encoder call {}: kernel 2 vs plain {} (tol {}), vs plain bf16 {} (tol "
              "{})".format(len(errs), err, atol, same, same_tol))
        errs.append(err)
        return out

    with torch.inference_mode():
        mnn.flash_qkv_attention = held
        try:
            vit_forward(vit, x[:CLIP_CHECK_B], torch.bfloat16, flash=True)
        finally:
            mnn.flash_qkv_attention = real
        check(len(errs) == cfg.layers, "{} checked calls, {} layers".format(len(errs), cfg.layers))
        torch.cuda.synchronize()
        fa.launches = 0
        got = vit_forward(vit, x, torch.bfloat16, flash=True)
        torch.cuda.synchronize()
        launches = fa.launches
        plain = vit_forward(vit, x, torch.bfloat16, flash=False)
        ker_ms = cuda_time_ms(lambda: vit_forward(vit, x, torch.bfloat16, flash=True), 3, 1)
        plain_ms = cuda_time_ms(lambda: vit_forward(vit, x, torch.bfloat16, flash=False), 3, 1)
    check(launches == cfg.layers, "flash_attention launches {} != {}".format(launches, cfg.layers))
    check(got.shape == (CLIP_B, gh * gw + 1, cfg.width) and torch.isfinite(got).all().item(),
          "CLIP encode: shape {} or non-finite".format(tuple(got.shape)))
    rel = ((got.float() - plain.float()).norm() / plain.float().norm()).item()
    check(rel <= 2 ** -5, "CLIP encode, kernel 2 on vs off: relative L2 {}".format(rel))
    log("CLIP archive ViT-L/14 (GIT_LARGE_COCO's encoder + proj [1024, 768] + a tiny text tower, "
        "{:.1f} MiB): written in {:.2f} s, loaded with verify='warn' and resized to {} px "
        "({}x{} table) on the card in {:.2f} s; encode of {}x{} inputs (grid {}x{}, S={}), bf16: "
        "kernel 2 on all {} calls of {} images within check_flash_case's bounds (max|out-plain_f32| "
        "{:.3e}); B={}: {} launches, {:.2f} ms per batch (events) against {:.2f} with flash=False, "
        "outputs {:.3e} apart (relative L2) [{}]".format(
            size / 2 ** 20, write_s, CLIP_RES, cfg.grid, cfg.grid, load_s, CLIP_HW[0], CLIP_HW[1],
            gh, gw, gh * gw + 1, len(errs), CLIP_CHECK_B, max(errs), CLIP_B, launches, ker_ms,
            plain_ms, rel, card))
    del vit, got, plain
    torch.cuda.empty_cache()
    log("phase 31 (the CLIP-loaded encoder) {:.1f} s".format(time.perf_counter() - t0))
    return launches


P32_BEAM = dict(num_beams=4, max_steps=41, norm_max_length=1024, do_sample=True,
                temperature=0.7, top_k=50, top_p=0.9, repetition_penalty=1.2)
P32_R = 2  # num_return_sequences


def p32_generate(engine, seed, **kw):
    """The sampled search's `generate` arguments (phase 19's settings,
    P32_R sequences an input), a generator on the card from `seed`."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig

    return dict(beam=BeamSearchConfig(**P32_BEAM), decode_kernel=True,
                num_return_sequences=P32_R, rng=torch.Generator("cuda").manual_seed(seed), **kw)


def p32_sample(engine, items, prefixes, generate):
    """One device batch of `items` through `dispatch_device_batch` with
    `generate`: the [B * R, L] sequences on the host."""
    import numpy as np

    return engine.to_host(engine.dispatch_device_batch(np.stack(items), np.asarray(prefixes),
                                                       **generate))


def p32_one_card(cpu_model, tok, inputs, seed):
    """One card's f32 sampled tokens of (a)'s first COCO rows."""
    import torch

    from gitax_torch.runtime.engine import CaptionEngine

    items, prefixes = [x[:P23_PARITY_ROWS] for x in inputs["coco"]]
    with CaptionEngine(build_model("cuda", torch.float32, cpu_model), tok,
                       batch_size=P23_PARITY_ROWS, dtype=torch.float32, use_native=False) as engine:
        out = p32_sample(engine, items, prefixes, p32_generate(engine, seed))
    torch.cuda.empty_cache()
    return out


def p32_sampling(card, group, cpu_model, tok, inputs, seed, want, coco, coco_tok, items, pref):
    """32 (in 23). Sampling on a tensor-parallel model, [1, 2]: (a)'s cut
    model in f32, its first COCO rows through the engine with phase 19's
    sampled search and P32_R sequences an input, a generator on the card
    seeded from `seed` (the follower's comes by pickle; `generate` gives
    each rank the state of the model group's rank 0): one card's tokens
    (`want`), the ranks equal; then GIT_LARGE_COCO at full size, bf16 +
    int8, B=32: ms per beam step (host clock over rank 0's decode steps)
    sampled and, in the same engine, beam search as phase 23 runs it.
    Returns the kernels' launches over every rank."""
    import numpy as np
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig

    t0 = time.perf_counter()
    rows = [x[:P23_PARITY_ROWS] for x in inputs["coco"]]

    def parity():
        engine = group.engine((1, 2), build_model("cuda", torch.float32, cpu_model), tok,
                              batch_size=P23_PARITY_ROWS, dtype=torch.float32, decode_kernel=True)
        with engine:
            return p32_sample(engine, *rows, p32_generate(engine, seed)), engine.group_mismatches

    (got, unequal), _, launches = mesh_run(group, parity)
    differ = [i for i in range(len(want)) if not np.array_equal(got[i], want[i])]
    check(got.shape == want.shape and not differ, "TP sampling f32 [1, 2]: rows {} differ from one "
          "card's: {} vs {}".format(differ, [got[i].tolist() for i in differ[:2]],
                                    [want[i].tolist() for i in differ[:2]]))
    check(unequal == 0, "TP sampling: {} elements differ within the model group".format(unequal))
    log("TP sampling f32 [1, 2] (the cut model; temperature 0.7, top-k 50, top-p 0.9, repetition "
        "penalty 1.2, R={}, torch.Generator('cuda') seed {}): {} rows = one card's ({} distinct), "
        "the ranks equal; launches over every rank decode_attention {} flash_attention {} "
        "vocab_topk {}".format(P32_R, seed, len(got), len({tuple(r) for r in got.tolist()}),
                               *launches))

    def rate():
        engine = group.engine((1, 2), build_model("cuda", torch.bfloat16, coco), coco_tok,
                              batch_size=P23_ROWS, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                              dtype=torch.bfloat16, int8=True, fast_prefill=True, decode_kernel=True)
        out = {}
        with engine:
            sampled = p32_generate(engine, seed, fast_prefill=True)
            p32_sample(engine, items[:P23_ROWS], pref[:P23_ROWS], sampled)  # warm-up
            for label, kw in (("sampled", sampled), ("beam", None)):
                torch.cuda.synchronize()
                engine.model.decode_step_calls = 0
                t1 = time.perf_counter()
                if kw is None:
                    seqs = engine_tokens(engine, items[:P23_ROWS], pref[:P23_ROWS], P23_ROWS)
                else:
                    seqs = p32_sample(engine, items[:P23_ROWS], pref[:P23_ROWS], kw)
                wall = time.perf_counter() - t1
                steps = engine.model.decode_step_calls
                out[label] = (wall / steps * 1e3, steps, len({tuple(r) for r in seqs.tolist()}))
        return out, engine.group_mismatches

    (timed, unequal), peaks, more = mesh_run(group, rate)
    check(unequal == 0, "TP sampling bf16: {} elements differ within the model group".format(
        unequal))
    launches = [a + b for a, b in zip(launches, more)]
    log("TP sampling bf16+int8 [1, 2], GIT_LARGE_COCO B={}: sampled (R={}) {:.2f} ms per beam step "
        "over {} steps ({} distinct of {}), beam search {:.2f} ms per beam step over {} steps ({} "
        "distinct), host clock over rank 0's decode steps, a warm-up batch first; peak memory a "
        "rank {} MiB [{}; {}]".format(
            P23_ROWS, P32_R, timed["sampled"][0], timed["sampled"][1], timed["sampled"][2],
            P23_ROWS * P32_R, timed["beam"][0], timed["beam"][1], timed["beam"][2],
            ["%.1f" % p for p in peaks], card, mesh_layout(group.world,
                                                           torch.cuda.device_count())[1]))
    log("phase 32 (sampling on [1, 2], in 23) {:.1f} s".format(time.perf_counter() - t0))
    return launches


NATIVE_ROWS = 16


def phase_native(card, cpu_model, work):
    """33. The native loader (`gitax_torch.native`: g++ and libjpeg): one
    line with `available()` and, where it did not build, the build log's
    reason (then `use_native=None` decodes with PIL, as gitax does; the
    line counts as no check passed).  Where it built: NATIVE_ROWS JPEG rows
    through `run_caption_tsv` with use_native True and False: the same
    keys in order, each row one caption, and the share of equal captions
    (the loader's pixels are not PIL's)."""
    import base64
    import io
    import json

    import numpy as np
    import torch

    from gitax_torch import native
    from gitax_torch.io.image import pil_image
    from gitax_torch.io.tsv import TSVFile, tsv_writer
    from gitax_torch.preprocess.transforms import TestTransform
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    t0 = time.perf_counter()
    ok = native.available()
    log("native loader: available() {}; {} [{}]".format(
        ok, "built at {}".format(native.so_path()) if ok else
        "not built ({}): use_native=None decodes with PIL, as gitax does where the loader does "
        "not build; no check passed here".format(native.unavailable_reason()), card))
    if not ok:
        return
    rng = np.random.RandomState(33)
    rows = []
    for i in range(NATIVE_ROWS):
        buf = io.BytesIO()
        pil_image().fromarray(rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        rows.append(["jpg{}".format(i), base64.b64encode(buf.getvalue())])
    tsv = os.path.join(work, "native.img.tsv")
    tsv_writer(rows, tsv)
    out = {}
    for use_native in (True, False):
        path = os.path.join(work, "native_{}.tsv".format(use_native))
        with CaptionEngine(build_model("cuda", torch.bfloat16, cpu_model),
                           BertTokenizer(build_tiny_vocab()), dtype=torch.bfloat16, int8=True,
                           transform=TestTransform(224), use_native=use_native) as engine:
            engine.run_caption_tsv(tsv, path)
        t = TSVFile(path)
        out[use_native] = [(t[i][0], json.loads(t[i][1])) for i in range(len(t))]
    keys = [[k for k, _ in out[b]] for b in (True, False)]
    check(keys[0] == keys[1] == [r[0] for r in rows], "native TSV keys {}".format(keys))
    check(all(len(c) == 1 for b in out for _, c in out[b]), "one caption a row")
    same = np.mean([a[1] == b[1] for a, b in zip(out[True], out[False])])
    log("native loader: {} JPEG rows through run_caption_tsv, use_native True and False: the same "
        "keys in order, one caption a row, {:.1%} of the captions equal; {:.1f} s [{}]".format(
            NATIVE_ROWS, same, time.perf_counter() - t0, card))


# -- the device-side search (phase 34) ---------------------------------------

P34_ROWS = 4  # (a): rows of each f32 comparison
P34_PASSES = 3  # (c), (f): passes each, eager and graph in turns
P34_LOAD_SECONDS = 5.0  # (f): each serving turn
P34_GRIDS = ((22, 40), (30, 30), (30, 40), (40, 30))  # phase 7's VQA grids


def cut_model(name, seed, gate, layers=2, attention=SHARPEN_17):
    """A zoo config at full width with its encoder cut to `layers` blocks
    (the search reads the decoder only: its depth and widths stay), random
    EOS-gated weights, the decoder's attention x `attention` (phase 17's
    x5 makes outputs depend on the input; x1 keeps the EOS gate's
    lengths, which x5 cuts short on the VQA and text-context configs)."""
    import dataclasses

    import torch

    from gitax_torch.models.config import config_from_param, get_model_param
    from gitax_torch.models.git import GitModel, eos_gate_

    cfg = config_from_param(get_model_param(name))
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, layers=layers))
    model = GitModel(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))
    eos_gate_(model, gate=gate)
    return sharpen_(model, attention=attention, projection=1)


def graph_against_eager(label, model, x, prefix=None, **kw):
    """`generate` on the graph path against the eager loop: its first call
    (the capture) on the inputs, then the cached graph on the rows in
    reverse order (its static buffers then hold the first batch's
    state), each against the eager loop on the same rows: tokens equal,
    logprobs within 1e-6.  Returns the graph's sequences."""
    import torch

    def rows(flip):
        def f(t):
            return t.flip(0) if flip and torch.is_tensor(t) else t

        return f(x), f(prefix), {k: [f(t) for t in v] if isinstance(v, list) else f(v)
                                 for k, v in kw.items()}

    for name, flip in (("capture", False), ("cached, rows reversed", True)):
        xs, ps, kws = rows(flip)
        eager = model.generate(xs, ps, eager_loop=True, **kws)
        got = model.generate(xs, ps, **kws)
        check(torch.equal(got[0], eager[0]), "{}: the graph's tokens ({}) differ from the eager "
              "loop's".format(label, name))
        err = (got[1].float() - eager[1].float()).abs().max().item()
        check(err <= 1e-6, "{}: logprobs ({}) differ by {}".format(label, name, err))
    seqs = got[0].reshape(-1, got[0].shape[-1])
    log("device loop (a) f32 {}: graph = eager loop (capture, and cached on the rows reversed), "
        "{} rows, {} distinct, "
        "mean length {:.2f}".format(label, seqs.shape[0], len({tuple(r) for r in seqs.tolist()}),
                                    (seqs != 102).sum(1).float().mean().item()))
    return got[0]


def device_table_noise(table):
    """A stand-in for `gumbel_noise` whose i-th draw since `reset` is
    table[i], counted on the card: a captured draw reads the count at each
    replay (the host-counted `replayed` is read once, at capture)."""
    import torch

    i = torch.zeros((), dtype=torch.long, device=table.device)

    def noise(shape, generator):
        check(tuple(shape) == tuple(table.shape[1:]), "noise asked for {}".format(tuple(shape)))
        out = table.index_select(0, i.reshape(1))[0]
        i.add_(1)
        return out

    noise.reset = i.zero_
    return noise


def p34_parity(images, seed):
    """(a) f32: the graph path's tokens equal the eager loop's on the card."""
    import torch

    from gitax_torch.decode import beam as beam_mod
    from gitax_torch.decode import device_loop
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.decode.trie import build_vocab_trie
    from gitax_torch.ops.quant import quantize_git_model_
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab, encode_prefix

    f32 = torch.float32
    beam = BeamSearchConfig(num_beams=4, max_steps=41, norm_max_length=1024)
    model = build_model("cuda", f32, cut_model("GIT_LARGE_COCO", seed, 12))
    x = normalized(images[:P34_ROWS], f32)
    graph_against_eager("COCO beam", model, x, beam=beam, decode_kernel=True)
    graph_against_eager("COCO beam, repetition penalty 1.3, num_keep_best 2", model, x,
                        beam=dataclasses_replace(beam, repetition_penalty=1.3, num_keep_best=2),
                        decode_kernel=True)
    graph_against_eager("greedy", model, x, mode="greedy")
    trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(TRIE_WORDS)), TRIE_CLASSES)
    graph_against_eager("trie", model, x, mode="trie", trie=trie)
    # sampling: fresh generators of one seed on both sides (the graph's draw
    # is the eager loop's), then one table of draws made outside the graph
    # fed to both
    sb = dataclasses_replace(beam, do_sample=True, temperature=0.7, top_k=50, top_p=0.9,
                             repetition_penalty=1.2)
    for s in (seed, seed + 1):
        eager = model.generate(x, beam=sb, decode_kernel=True, eager_loop=True,
                               rng=torch.Generator("cuda").manual_seed(s))
        graph = model.generate(x, beam=sb, decode_kernel=True,
                               rng=torch.Generator("cuda").manual_seed(s))
        check(torch.equal(graph[0], eager[0]), "sampling f32: the graph's tokens differ from the "
              "eager loop's with generators of seed {}".format(s))
    device_loop.release(model)
    table = torch.empty((sb.max_steps - 1, P34_ROWS * 4, model.cfg.vocab_size), device="cuda")
    table = -table.exponential_(generator=torch.Generator("cuda").manual_seed(seed)).log()
    noise, orig = device_table_noise(table), beam_mod.gumbel_noise
    beam_mod.gumbel_noise = noise
    try:
        outs = []
        for eager_loop in (True, False, False, True):
            noise.reset()
            outs.append(model.generate(x, beam=sb, decode_kernel=True, eager_loop=eager_loop,
                                       rng=torch.Generator("cuda")))
    finally:
        beam_mod.gumbel_noise = orig
    for got, want, name in ((outs[1], outs[0], "capture"), (outs[2], outs[3], "cached")):
        check(torch.equal(got[0], want[0]), "sampling f32 on one noise table: the graph's tokens "
              "({}) differ from the eager loop's".format(name))
    log("device loop (a) f32 sampling (temperature 0.7, top-k 50, top-p 0.9, penalty 1.2): graph "
        "= eager loop with generators of seeds {} and {} (the graph's draw registered), and on "
        "one table of draws made outside the graph (capture and cached); {} distinct "
        "rows".format(seed, seed + 1, len({tuple(r) for r in outs[1][0].tolist()})))
    del model
    device_loop.settle()

    # VQA: the four grids and both question lengths (a key each)
    vqa = build_model("cuda", f32, cut_model("GIT_LARGE_VQAv2", seed + 1, 16, attention=1))
    tok = BertTokenizer(build_tiny_vocab(VQA_WORDS))
    g = torch.Generator().manual_seed(seed)
    p = vqa.cfg.encoder.patch_size
    for gh, gw in P34_GRIDS:
        xv = torch.randn(P34_ROWS, gh * p, gw * p, 3, generator=g).cuda()
        for q in VQA_QUESTIONS:
            pref = torch.tensor([encode_prefix(tok, q, 40)] * P34_ROWS, device="cuda")
            graph_against_eager("VQA {}x{}, prefix {}".format(gh, gw, pref.shape[1]), vqa, xv, pref,
                                beam=dataclasses_replace(beam, max_steps=pref.shape[1] + 40),
                                decode_kernel=True)
    del vqa

    # video, int8 decoder and head, with and without the vocab kernel
    video = quantize_git_model_(build_model("cuda", f32, cut_model("GIT_LARGE_VATEX", seed + 2, 12)))
    clips = torch.randn(P34_ROWS, FRAMES, 224, 224, 3, generator=g).cuda()
    for vocab_kernel in (True, False):
        graph_against_eager("video (M = {}), vocab_kernel={}".format(FRAMES * 257, vocab_kernel),
                            video, clips, cls_prefix(clips), beam=beam, decode_kernel=True,
                            vocab_kernel=vocab_kernel)
    del video

    # text context: kernel 1 with mem_bias
    ctx = build_model("cuda", f32, cut_model("GIT_BASE_COCO", seed + 3, 12, attention=1))
    imgs, toks, lens = context_inputs(P34_ROWS, seed)
    xc = normalized(imgs, f32)
    graph_against_eager("text context (M = {}, mem_bias)".format(CTX_M), ctx, xc, cls_prefix(xc),
                        beam=beam, decode_kernel=True, context_tokens=[t.cuda() for t in toks],
                        context_lengths=[t.cuda() for t in lens])
    del ctx
    device_loop.settle()
    torch.cuda.empty_cache()


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def if_graph_of(fn, side=None):
    """fn() captured into a CUDAGraph (keep_graph) and wrapped in
    `device_loop.IfGraph` under a predicate of its own; (IfGraph, pred,
    fn's output)."""
    import torch

    from gitax_torch.decode.device_loop import IfGraph

    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    body = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(body, stream=side):
        out = fn()
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    return IfGraph(body, pred), pred, out


def check_decode_in_graph():
    """(b) kernel 1 inside a replayed conditional graph: a captured call on
    static COCO-shaped buffers, replayed at pos 0, 12 and T-1 with new
    inputs copied in, held to the plain version as `check_decode_case`
    holds the eager launch (bf16, bf16 with int8 memory, f32); a launch
    with the predicate false writes nothing."""
    import torch

    from gitax_torch.decode import device_loop
    from gitax_torch.ops.decode_attention import decode_attention_cuda

    from gitax_torch.ops.decode_attention import decode_attention

    g = torch.Generator().manual_seed(34)
    kw = dict(beams=K, num_heads=H, head_dim=DH)
    launches, kernel1 = device_loop.launches, decode_attention.launches
    worst = 0.0
    for name, dtype, mem_int8 in (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
                                  ("bf16+int8mem", torch.bfloat16, True)):
        static = decode_inputs(g, dtype, mem_int8, 0)
        cond, pred, out = if_graph_of(lambda: decode_attention_cuda(**static, **kw))
        for pos in (0, 12, T - 1):
            a = decode_inputs(g, dtype, mem_int8, pos)

            def replayed(**b):
                for key, t in b.items():
                    if torch.is_tensor(t) and key not in ("txt_kv",):
                        static[key].copy_(t)
                static["txt_kv"].copy_(b["txt_kv"])
                cond.launch()
                b["txt_kv"].copy_(static["txt_kv"])
                return out.clone()

            err = check_decode_case("{:12s} pos={:2d}, replayed in a graph".format(name, pos), a,
                                    dtype, mem_int8, kw, launch=replayed)
            worst = max(worst, err) if name == "bf16" else worst
        before, cache = out.clone(), static["txt_kv"].clone()
        static["pos"].fill_(5)
        pred.fill_(False)
        cond.launch()
        torch.cuda.synchronize()
        check(torch.equal(out, before) and torch.equal(static["txt_kv"], cache),
              "decode kernel in a graph: a launch under a false predicate wrote")
    # comparisons, not the path's launches
    device_loop.launches, decode_attention.launches = launches, kernel1
    log("device loop (b): kernel 1 inside a replayed conditional graph within check_decode_case's "
        "bounds at pos 0, 12, {} (f32, bf16, bf16 + int8 memory); a launch under a false "
        "predicate writes nothing".format(T - 1))
    return worst


def phase_graph_kernel(card):
    """The conditional graph's own kernel (`set_condition`, csrc/graph_if.cu):
    a launch under a false predicate skips its body, under a true one
    runs it, as the eager loop's host branch does (the difference of the
    two counts is max_abs_err); its device time per launch (profiler),
    the host's read of a predicate (`bool(pred)`, the eager loop's per
    step: plain_ms) and its bound (one byte read)."""
    import torch

    from gitax_torch.decode import device_loop

    launches = device_loop.launches
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    cond, pred, _ = if_graph_of(lambda: count.add_(1))
    count.zero_()  # the warm-up's
    want = 0
    for flag in (True, False, True, True, False):
        pred.fill_(flag)
        cond.launch()
        want += int(flag)
    err = abs(int(count) - want)
    check(err == 0, "set_condition: {} bodies ran, {} predicates were true".format(int(count), want))
    pred.fill_(False)
    ker_ms = device_ms(cond.launch, 200, "set_condition")
    call_ms = cuda_time_ms(cond.launch, 1000)
    t0 = time.perf_counter()
    for _ in range(200):
        bool(pred)
    plain_ms = (time.perf_counter() - t0) / 200 * 1e3
    bound_ms, bound_by = bound(1, 0, F32_FLOPS)
    device_loop.launches = launches  # comparisons, not the path's launches
    log("graph_if: set_condition {:.4f} ms on the device (profiler), a skipped launch {:.4f} ms "
        "back to back (events, the host's enqueue included); the eager loop's host read of the "
        "predicate {:.4f} ms; bound {:.2e} ms ({}: 1 byte) [{}]".format(
            ker_ms, call_ms, plain_ms, bound_ms, bound_by, card))
    return dict(max_abs_err=float(err), ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def busy_profile(fn):
    """fn() then a synchronize under torch.profiler: (the device's busy
    share of the span from its first activity to its last, device busy ms,
    span ms, the host's kernel and graph launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    check(spans, "the profile shows no device activity")
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = spans[-1][1] - spans[0][0]
    host = collections.Counter(e.name for e in events if e.device_type == DeviceType.CPU
                               and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                              "cudaLaunchKernelEx", "cudaGraphLaunch"))
    return busy / span, busy / 1e3, span / 1e3, dict(host)


def p34_coco(card, cpu_model, images, work):
    """(c)-(g) on GIT_LARGE_COCO at full size, bf16 + int8, B=32, the
    engine's search settings."""
    import functools

    import numpy as np
    import torch

    from gitax_torch.decode import device_loop
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.models.git import GitModel
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    tok = BertTokenizer(build_tiny_vocab())
    model = build_model("cuda", torch.bfloat16, cpu_model)
    from gitax_torch.preprocess.transforms import TestTransform

    engine = CaptionEngine(model, tok, batch_size=32,
                           beam=BeamSearchConfig(num_beams=4, max_steps=40), dtype=torch.bfloat16,
                           int8=True, fast_prefill=True, decode_kernel=True,
                           transform=TestTransform(crop_size=224), use_native=False)
    beam = engine.beam_for(1)
    x = normalized(images[:32], torch.bfloat16)
    kw = dict(beam=beam, dtype=torch.bfloat16, fast_prefill=True, decode_kernel=True)

    # (g) the first graph search of the key: capture time, memory beyond
    # the eager loop's peak, and what the graph keeps
    model.generate(x, eager_loop=True, **kw)  # cuBLAS, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.generate(x, eager_loop=True, **kw)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.generate(x, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    loop = device_loop.graphs(model)[-1]
    log("device loop (g) COCO B=32 bf16+int8: the first graph search {:.3f} s, its capture {:.3f} s "
        "(the warm-up step excluded); peak memory above the weights {:.1f} MiB against the eager "
        "loop's {:.1f} MiB (+{:.1f} MiB); the graph keeps {:.1f} MiB (its static state and pool) "
        "[{}]".format(first_s, loop.capture_s, graph_peak / 2**20, eager_peak / 2**20,
                      (graph_peak - eager_peak) / 2**20, held / 2**20, card))

    # (c) ms per beam step, eager and graph in turns
    readings = {True: [], False: []}
    for eager_loop in [True, False, False, True, True, False][:2 * P34_PASSES]:
        spans = SearchSpans(model)
        device_loop.settle()
        model.decode_step_calls = 0
        model.generate(x, eager_loop=eager_loop, **kw)
        torch.cuda.synchronize()
        device_loop.settle()
        readings[eager_loop].append(spans.loop_ms() / model.decode_step_calls)
        steps = model.decode_step_calls
        spans.remove()
    med = {k: sorted(v)[len(v) // 2] for k, v in readings.items()}
    log("device loop (c) COCO B=32 bf16+int8, {} beam steps a search: ms per beam step (device "
        "events: the search less encode and prefill) eager {} (median {:.3f}, spread {:.3f}), "
        "graph {} (median {:.3f}, spread {:.3f}); eager / graph {:.2f}x [{}]".format(
            steps, ["%.3f" % v for v in readings[True]], med[True],
            max(readings[True]) - min(readings[True]), ["%.3f" % v for v in readings[False]],
            med[False], max(readings[False]) - min(readings[False]), med[True] / med[False], card))

    # (d) launches from the host and the device's busy share, one batch
    rows = {}
    for eager_loop in (True, False):
        replays = loop.replays
        share, busy, span, host = busy_profile(
            lambda: model.generate(x, eager_loop=eager_loop, **kw))
        rows[eager_loop] = (share, busy, span, host, loop.replays - replays)
    for eager_loop, (share, busy, span, host, replays) in rows.items():
        log("device loop (d) COCO B=32, {}: device busy {:.1%} of {:.2f} ms ({:.2f} ms busy); host "
            "launches {}{} [{}]".format(
                "eager loop" if eager_loop else "graph", share, span, busy, host,
                "" if eager_loop else ", {} of them the search's graph launches".format(replays),
                card))

    # (e) dispatch returns before the search ends: host ms against device
    # ms, and no synchronising call on the way (sync debug mode)
    arr = np.stack(images[:32])
    pref = np.full((32, 1), tok.cls_token_id, np.int64)
    engine.to_host(engine.dispatch_device_batch(arr, pref))
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            seqs = engine.dispatch_device_batch(arr, pref)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        engine.to_host(seqs)
        dev.append(start.elapsed_time(end))
    check(max(host) < min(dev), "dispatch's host ms {} not below the search's device ms {}".format(
        host, dev))
    log("device loop (e) COCO B=32: dispatch_device_batch returns after {} host ms, the batch's "
        "device work takes {} ms; no synchronising call inside dispatch (sync debug mode 'error') "
        "[{}]".format(["%.2f" % h for h in host], ["%.2f" % d for d in dev], card))

    # (f) the engine, the TSV loop and the server, eager against graph in turns
    def eager_on(m, on):
        if on:
            m.generate = functools.partial(GitModel.generate, m, eager_loop=True)
        elif "generate" in m.__dict__:
            del m.generate

    rates = collections.defaultdict(list)
    prefixes = [[tok.cls_token_id]] * 96
    engine.generate_batch(images[:96], prefixes)
    tsv_in = os.path.join(work, "coco.img.tsv")
    order = [True, False, False, True, True, False][:2 * P34_PASSES]
    for eager_loop in order:
        eager_on(model, eager_loop)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.resolve(engine.dispatch(images[:96], prefixes))
            rates["engine", eager_loop].append(96 / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            engine.run_caption_tsv(tsv_in, os.path.join(work, "p34.out.tsv"))
            rates["tsv", eager_loop].append(COCO_TSV_ROWS / (time.perf_counter() - t0))
        finally:
            eager_on(model, False)
    engine.close()
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    stack_engine, batcher = serving_stack(work, "bfloat16", int8=True)
    payloads = [base64_png(a) for a in images[:32]]
    bodies = [json.dumps({"image": p}).encode() for p in payloads]
    try:
        batcher.warm(prefix_lens=(1,))
        with Served(batcher) as srv:
            for eager_loop in order[:4]:
                eager_on(stack_engine.model, eager_loop)
                try:
                    lat, bad, sent, load_s = closed_loop(srv.base, bodies, P34_LOAD_SECONDS)
                finally:
                    eager_on(stack_engine.model, False)
                check(not bad, "serving errors: {}".format(sorted(set(bad))))
                rates["serving", eager_loop].append(
                    (sent / load_s, float(np.percentile(np.asarray(lat) * 1e3, 99))))
    finally:
        batcher.close()
        stack_engine.close()
    for what, unit in (("engine", "images/s"), ("tsv", "images/s")):
        log("device loop (f) COCO {} {}: eager {} graph {} (in turns {}) [{}]".format(
            what, unit, ["%.2f" % r for r in rates[what, True]],
            ["%.2f" % r for r in rates[what, False]],
            ["eager" if e else "graph" for e in order], card))
    log("device loop (f) serving, {} closed-loop clients for {:.0f} s a turn: eager {} graph {} "
        "(requests/s, p99 ms; in turns {}) [{}]".format(
            LOAD_CLIENTS, P34_LOAD_SECONDS,
            [("%.2f" % r, "%.1f" % p) for r, p in rates["serving", True]],
            [("%.2f" % r, "%.1f" % p) for r, p in rates["serving", False]],
            ["eager" if e else "graph" for e in order[:4]], card))
    del stack_engine, batcher
    gc.collect()
    torch.cuda.empty_cache()


def base64_png(img):
    import base64

    return base64.b64encode(png_bytes(img)).decode()


def phase_device_loop(card, cpu_model, images, work, seed):
    """34. The device-side search: (a) f32 tokens of the graph path against
    the eager loop; (b) kernel 1 inside a replayed graph against its
    plain version; (c)-(g) on GIT_LARGE_COCO bf16 + int8: ms per beam step
    eager and graph in turns, launches and the device's busy share,
    dispatch's host ms against the search's device ms, the engine, TSV and
    serving rates in turns, capture time and memory.  Returns kernel 1's
    launches (the eager loop's and the replays')."""
    from gitax_torch.ops.decode_attention import decode_attention

    t0 = time.perf_counter()
    settle()
    d0 = decode_attention.launches
    p34_parity(images, seed)
    check_decode_in_graph()
    p34_coco(card, cpu_model, images, work)
    settle()
    log("phase 34 (the device-side search) {:.1f} s".format(time.perf_counter() - t0))
    return decode_attention.launches - d0


def main(argv):
    import torch

    global PROFILE
    args = list(argv)
    PROFILE = "--profile" in args
    if PROFILE:
        args.remove("--profile")
    seed = 0
    if args[:1] == ["--seed"] and len(args) == 2 and args[1].isdigit():
        seed, args = int(args[1]), []
    check(not args, "usage: python3 chip_smoke.py [--profile] [--seed N]")
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
    phase_doctor(card)  # 24
    stats = {"decode_attention": phase_decode_kernel(card),  # 3
             "flash_attention": phase_flash_kernel(card),  # 4
             "vocab_topk": phase_vocab_kernel(card)}  # 9
    stats.update(phase_int8_kernels(card))  # 25
    stats["graph_if"] = phase_graph_kernel(card)  # 34's kernel

    # 13: the decoders; the TSVs and the checkpoint go in the checkout's
    # build tree, removed at the end
    work = os.path.join(ROOT, "build", "gitax_torch", "smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    phase_decoders(work)

    # 5, 6, 14, 16, 17: the COCO path; from here on every launch of a
    # search's conditional graph counts (its set_condition kernel)
    from gitax_torch.decode import device_loop

    device_loop.launches = 0
    coco = random_model("GIT_LARGE_COCO", seed=0, gate=12)
    coco_launches, images, coco_rate, coco_step_ms = phase_coco_slice(
        card, coco, BertTokenizer(build_tiny_vocab()), os.path.join(work, "trace"))  # and 29
    phase_coco_f32_parity(coco, images)
    tsv_d, tsv_rate, write_s = phase_coco_tsv(card, coco, images, work, coco_rate)
    phase_reference_checkpoint(card, coco, work, write_s)  # 27
    phase_tsv_f32_parity(coco, work)
    phase_greedy_trie(card, coco, work)
    t0 = time.perf_counter()
    serve_d, serve_rate = phase_serving(card, coco, images, work, coco_step_ms)  # 18
    t1 = time.perf_counter()
    sample_d = phase_sampling(card, coco, images, seed)  # 19
    log("phase 18 (serving) {:.1f} s, phase 19 (sampling) {:.1f} s".format(
        t1 - t0, time.perf_counter() - t1))
    p34_d = phase_device_loop(card, coco, images, work, seed)  # 34, on phase 14's TSV

    # 7, 8, 15: the VQA path
    # past the 14-token question prefix: answers of ~2 and ~9 tokens
    vqa = random_model("GIT_LARGE_VQAv2", seed=1, gate=16)
    vqa_tok = BertTokenizer(build_tiny_vocab(VQA_WORDS))
    vqa_d, vqa_f, pairs, vqa_rate = phase_vqa_slice(card, vqa, vqa_tok)
    phase_vqa_f32_parity(vqa, pairs)
    vqa_tsv_d, vqa_tsv_f, _ = phase_vqa_tsv(card, vqa, vqa_tok, work, vqa_rate)

    # 26: the w8a8 encoder on the COCO and VQA paths
    w8a8_launches, w8a8_tokens = phase_w8a8_path(card, coco, vqa, images, seed)

    # 23: inference on a mesh, on phase 14's checkpoint and TSV (with 28, row
    # shards over hosts, and the w8a8 cut model on [1, 2])
    mesh_d, mesh_rows, mesh_int8 = phase_mesh_infer(card, coco, vqa, images, work, seed,
                                                    {"coco_tsv": tsv_rate,
                                                     "serving": serve_rate}, w8a8_tokens)
    # 31: a CLIP ViT-L/14 archive (COCO's encoder weights) resized to 480 px;
    # 33: the native loader
    clip_f = phase_clip_encoder(card, coco, work, seed)
    phase_native(card, coco, work)
    del coco
    del vqa, pairs
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    # 30: CLIP's RN50 and its text tower
    phase_clip_towers(card, seed)

    # 10, 11, 12: the video path
    video = video_model(seed=2)
    model, engine, clips, video_d, video_f = phase_video_slice(card, video, BertTokenizer(
        build_tiny_vocab()))
    vocab_launches = phase_vocab_path(card, model, engine, clips)
    beam = engine.beam_for(1)
    del model, engine
    torch.cuda.empty_cache()
    phase_video_f32_parity(video, clips, beam)
    del video, clips
    torch.cuda.empty_cache()

    # 20: text context
    t0 = time.perf_counter()
    context_d = phase_context(card, seed)
    log("phase 20 (text context) {:.1f} s".format(time.perf_counter() - t0))

    # 21: training; 22: training on a mesh; their fine-tunes write in the
    # work dir, removed after
    os.makedirs(work)
    train_rate = phase_train(card, work, seed)
    phase_mesh(card, work, seed, train_rate)
    shutil.rmtree(work)

    settle()
    launches = {"decode_attention": coco_launches + vqa_d + video_d + tsv_d + vqa_tsv_d
                + serve_d + sample_d + context_d + mesh_d[0] + p34_d,
                "flash_attention": vqa_f + video_f + vqa_tsv_f + mesh_d[1] + clip_f,
                "vocab_topk": vocab_launches + mesh_d[2],
                "int8_quantize_rows": w8a8_launches[0] + mesh_int8[0],
                "int8_scale_rows": w8a8_launches[1] + mesh_int8[1],
                "graph_if": device_loop.launches}
    stats["decode_attention"]["launches_with_mem_bias"] = context_d
    check(all(n > 0 for n in launches.values()), "a kernel of the path was not launched: "
          "{}".format(launches))
    log("main-path launches: decode_attention {} (COCO {} + VQA {} + video {} + COCO TSV {} + VQA "
        "TSV {} + serving {} + sampling {} + text context {}, the last with mem_bias, + mesh {} + "
        "the device-side search {}), "
        "flash_attention {} (VQA {} + video {} + VQA TSV {} + mesh {} + CLIP encoder {}), "
        "vocab_topk {} (video, "
        "vocab_kernel on, {} + mesh {}; 0 under sampling); the mesh's counted over every rank; "
        "int8_quantize_rows {} and int8_scale_rows {} (the w8a8 encoder, {} and {} + the mesh's "
        "rank 0 {} and {}); graph_if {} (the searches' graph launches on one card, every phase); "
        "all phases {:.1f} s".format(
            launches["decode_attention"], coco_launches, vqa_d, video_d, tsv_d, vqa_tsv_d, serve_d,
            sample_d, context_d, mesh_d[0], p34_d, launches["flash_attention"], vqa_f, video_f,
            vqa_tsv_f,
            mesh_d[1], clip_f, launches["vocab_topk"], vocab_launches, mesh_d[2],
            launches["int8_quantize_rows"], launches["int8_scale_rows"], w8a8_launches[0],
            w8a8_launches[1], mesh_int8[0], mesh_int8[1], launches["graph_if"],
            time.perf_counter() - t_start))
    for name, rows in mesh_rows.items():
        log("{} at a mesh rank's shapes: {}".format(name, json.dumps(rows)))
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
