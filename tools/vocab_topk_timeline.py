#!/usr/bin/env python3
"""Where the bf16 vocab-head kernel's time goes, per CTA, on one NVIDIA GPU.

    python3 tools/vocab_topk_timeline.py

The machine has no ncu or nsys, so the kernel stamps itself: this script
copies gitax_torch/csrc/vocab_topk.cu, inserts clock64 and %globaltimer
stamps at the phase boundaries (thread 0 of the consumers, lane 0 of the
producer warp, one record per CTA in a __device__ array), builds the copy
with nvcc, binds it with ctypes in place of the wrapper's kernel and runs it
at the beam step's shape (R = 128, W = 768, V = 30522, bf16, four weight
copies in turn so the matrix does not sit in L2).  It prints each phase's
median, p10 and p90 over the CTAs, and the same for three ablations of the
main loop that give wrong logits and are only timed: `noconv` (the raw
bytes go to wgmma unwidened), `nolds` (no shared-memory loads of the
weights either: the products alone) and `nomma` (the loads and conversions
alone).  The stamps cost about 1 us of the CTA's life.  Nothing is written
into the repository; the copies go to a temporary directory.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "gitax_torch", "csrc", "vocab_topk.cu")
R, W, V = 128, 768, 30522

STAMP = '''namespace tc {
__device__ unsigned long long g_ts[1024][16];
// slot 0 and 7: %globaltimer at the CTA's start and end; 15 and 14: clock64
// there; 13: the SM; the others: clock64 at a phase boundary
__device__ __forceinline__ void stamp(int i, int who) {
  if ((int)threadIdx.x == who) {
    unsigned long long t = clock64();
    if (i == 0 || i == 7) {
      g_ts[blockIdx.x][i == 0 ? 15 : 14] = t;
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    }
    g_ts[blockIdx.x][i] = t;
    if (i == 0) {
      unsigned int smid;
      asm volatile("mov.u32 %0, %smid;" : "=r"(smid));
      g_ts[blockIdx.x][13] = smid;
    }
  }
}
'''

# (text in the kernel source, what takes its place); the producer's lane 0
# is thread 256
STAMPS = (
    ("namespace tc {\n", STAMP),
    ("  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n      mbar_init",
     "  stamp(0, 0);\n  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n"
     "      mbar_init"),
    ("  __syncthreads();\n\n  if (warp_id == kProducerWarp) {",
     "  __syncthreads();\n  stamp(1, 0);\n\n  if (warp_id == kProducerWarp) {"),
    ("        tma_load(hring + s * kHBytes, &hmap, &full[s], it * kKC, r0);\n",
     "        tma_load(hring + s * kHBytes, &hmap, &full[s], it * kKC, r0);\n"
     "        if (it == 0) stamp(8, 256);\n        if (it == kStages - 1) stamp(9, 256);\n"
     "        if (it == nk - 1) stamp(11, 256);\n"),
    ("      const uint32_t ws = wbase + s * kWBytes;\n",
     "      if (it == 0) stamp(2, 0);\n      const uint32_t ws = wbase + s * kWBytes;\n"),
    ("#pragma unroll\n    for (int mt = 0; mt < kMT; ++mt) fence_regs(acc[mt]);\n",
     "#pragma unroll\n    for (int mt = 0; mt < kMT; ++mt) fence_regs(acc[mt]);\n    stamp(3, 0);\n"),
    ("    consumer_sync();\n    // a warp per row", "    consumer_sync();\n    stamp(4, 0);\n    // a warp per row"),
    ("  // the block's statistics: after the barrier", "  stamp(5, 0);\n  // the block's statistics: after the barrier"),
    ("  cluster.sync();\n  if (rank == 0 &&", "  cluster.sync();\n  stamp(6, 0);\n  if (rank == 0 &&"),
    ("    bsum[o] = s;\n  }\n}", "    bsum[o] = s;\n  }\n  stamp(7, 0);\n}"),
    ('extern "C" {\n',
     'extern "C" {\nint dump_ts(void* dst) { return (int)cudaMemcpyFromSymbol(dst, tc::g_ts, '
     'sizeof(tc::g_ts)); }\n'),
)

ABLATIONS = {
    "kernel": (),
    "noconv": (("widen4(x[mt][i], &a[mt][i], &a[mt][2 + i]);",
                "a[mt][i] = x[mt][i], a[mt][2 + i] = x[mt][i] ^ 0x01010101u;"),),
    "nolds": (("x[mt][i] = __byte_perm(lds32(at), lds32(at + 8), pick);", "x[mt][i] = at ^ pick;"),
              ("widen4(x[mt][i], &a[mt][i], &a[mt][2 + i]);",
               "a[mt][i] = x[mt][i], a[mt][2 + i] = x[mt][i] ^ 0x01010101u;")),
    "nomma": (("          wgmma_rs(acc[mt], a[mt], db);\n",
               '          asm volatile("" ::"r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), '
               '"r"(a[mt][3]), "l"(db));\n'),),
}

PHASES = ((1, "barriers initialised"), (8, "producer: stage 0 issued"),
          (9, "producer: the ring's stages issued"), (2, "consumers: the first stage has landed"),
          (11, "producer: the last stage issued"), (3, "main loop done"),
          (4, "logits staged in shared memory"), (5, "rows stored, statistics taken"),
          (6, "cluster barrier passed"))


def substitute(text, pairs):
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError("the kernel source has {} of {!r}: bring this script up to "
                               "date".format(text.count(old), old))
        text = text.replace(old, new)
    return text


def variants():
    """name -> the stamped source, with that ablation applied."""
    stamped = substitute(open(SOURCE).read(), STAMPS)
    return {name: substitute(stamped, pairs) for name, pairs in ABLATIONS.items()}


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from gitax_torch.ops import cuda_build
    from gitax_torch.ops import vocab_topk as vt

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    copies = []
    for _ in range(4):
        q = torch.randint(-127, 128, (V, W), generator=g, dtype=torch.int8, device="cuda")
        copies.append((torch.randn(R, W, generator=g, device="cuda").to(torch.bfloat16), q.t(),
                       torch.rand(V, generator=g, device="cuda") * 1e-3 + 1e-4,
                       torch.randn(V, generator=g, device="cuda") * 0.1))
    ctas = vt.tile_plan(R, W, V)["ctas"]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, text in variants().items():
            cu, lib = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
            with open(cu, "w") as f:
                f.write(text)
            flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            procs[name] = (subprocess.Popen([cuda_build.find_nvcc(), *flags, "-o", lib, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), lib)
        for name, (proc, path) in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on {}:\n{}".format(name, out))
            lib = ctypes.CDLL(path)
            fn = lib.gitax_vocab_topk
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            lib.dump_ts.argtypes = [ctypes.c_void_p]
            vt._KERNEL = (fn, vt.TILE)
            for i in range(13):
                vt.vocab_logits_topk_cuda(*copies[i % 4])
            torch.cuda.synchronize()
            buf = np.zeros((1024, 16), dtype=np.uint64)
            if lib.dump_ts(buf.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            t = buf[:ctas].astype(np.int64)
            life_us = (t[:, 7] - t[:, 0]) / 1e3
            ghz = float(np.median((t[:, 14] - t[:, 15]) / (life_us * 1e3)))
            start = (t[:, 0] - t[:, 0].min()) / 1e3
            print("== {}{}: {} CTAs on {} SMs, starts within {:.2f} us, SM clock {:.3f} GHz, CTA "
                  "life median {:.2f} us (p90 {:.2f}) [{}]".format(
                      name, "" if name == "kernel" else " (wrong logits, timed only)", ctas,
                      len(set(t[:, 13].tolist())), start.max(), ghz, np.median(life_us),
                      np.percentile(life_us, 90), card))
            for slot, label in PHASES:
                d = (t[:, slot] - t[:, 15]) / ghz / 1e3
                print("   +{:6.2f} us (p10 {:6.2f}, p90 {:6.2f})  {}".format(
                    np.median(d), np.percentile(d, 10), np.percentile(d, 90), label))
            loop = (t[:, 3] - t[:, 2]) / ghz / 1e3
            print("   main loop {:.2f} us, epilogue and barrier {:.2f} us".format(
                np.median(loop), np.median((t[:, 14] - t[:, 3]) / ghz / 1e3)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
