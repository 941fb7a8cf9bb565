#!/usr/bin/env python3
"""How far f32 rounding moves greedy decoding on the card and on the CPU,
against the same weights in f64, as the decoder's attention is sharpened.

    python3 tools/greedy_rounding_sweep.py

GIT_LARGE_COCO with random weights (`chip_smoke.random_model`, seed 0, EOS
gate at 12), the first 8 of `chip_smoke.py` phase 5's random 224x224
images, and for each factor in 1, 2, 3, 5, 10 the decoder's attention
weights (q, k, v, out) scaled by it (`chip_smoke.sharpen_`, visual
projection unscaled).  Greedy and trie (`chip_smoke.TRIE_CLASSES`) run in
f32 on the card and on the CPU and in f64 on the CPU; every device's
logits are then taken on the CPU's tokens (`chip_smoke.forced_logits`).
Per factor and mode it prints the distinct outputs, the rows equal to
the CPU's, the quantiles (50, 90, 99, 100%) of each f32 side's error
against f64 relative to the step's largest |logit|, and each parting of
the card from the CPU with f64's top-2 margin there.  Needs one CUDA card;
builds no kernel (greedy and trie run the plain decode step).  This is how
`chip_smoke.py`'s SHARPEN_17 and ROUNDING_X were chosen.
"""

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch

    import chip_smoke as c
    from gitax_torch.decode.trie import build_vocab_trie
    from gitax_torch.models.git import GitModel
    from gitax_torch.preprocess.transforms import TestTransform
    from gitax_torch.io.image import pil_image
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    c.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(c.card_line(), flush=True)
    coco = c.random_model("GIT_LARGE_COCO", seed=0, gate=12)
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(8)]
    tf = TestTransform(crop_size=224)
    x = torch.from_numpy(np.stack([tf(pil_image().fromarray(a)) for a in images]))
    trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(c.TRIE_WORDS)), c.TRIE_CLASSES)
    eos = 102

    for factor in (1, 2, 3, 5, 10):
        t0 = time.perf_counter()
        sharp = c.sharpen_(copy.deepcopy(coco), attention=factor, projection=1)
        m64 = GitModel(sharp.cfg, device="cpu", dtype=torch.float64)
        m64.load_state_dict(sharp.state_dict())
        models = {"card": (c.build_model("cuda", torch.float32, sharp), torch.float32, x.cuda()),
                  "cpu": (sharp, torch.float32, x), "f64": (m64, torch.float64, x.double())}
        with torch.inference_mode():
            memory = {k: m.build_memory(xx, dtype=dt) for k, (m, dt, xx) in models.items()}
        for mode in ("greedy", "trie"):
            seqs = {k: m.generate(xx, mode=mode, trie=trie, dtype=dt)[0].cpu()
                    for k, (m, dt, xx) in models.items()}
            lg = {k: c.forced_logits(m, memory[k], seqs["cpu"], dt).double()
                  for k, (m, dt, _) in models.items()}
            err = {"card": [], "cpu": []}
            partings = []
            for b in range(x.shape[0]):
                row = seqs["cpu"][b].tolist()
                end = row.index(eos, 1) if eos in row[1:] else len(row) - 1
                for s in range(end):
                    scale = lg["f64"][b, s].abs().max().item()
                    for k in err:
                        err[k].append((lg[k][b, s] - lg["f64"][b, s]).abs().max().item() / scale)
                differ = [s for s in range(end) if seqs["card"][b, s + 1] != row[s + 1]]
                if differ:
                    s = differ[0]
                    top = torch.topk(lg["f64"][b, s], 2).values
                    partings.append("row {} step {}: f64 margin {:.3e}".format(
                        b, s, (top[0] - top[1]).item() / lg["f64"][b, s].abs().max().item()))
            print("x{} {}: distinct outputs card {} cpu {} f64 {}; rows equal to the CPU's: card {} "
                  "f64 {}; mean length {:.2f}; f32 error against f64 (q50, q90, q99, max): cpu {} "
                  "card {}; partings: {}".format(
                      factor, mode, *[len({tuple(r) for r in seqs[k].tolist()}) for k in models],
                      *[int((seqs[k] == seqs["cpu"]).all(1).sum()) for k in ("card", "f64")],
                      (seqs["cpu"] != eos).sum(1).float().mean().item(),
                      *[["{:.3g}".format(np.quantile(err[k], q)) for q in (0.5, 0.9, 0.99, 1.0)]
                        for k in ("cpu", "card")], "; ".join(partings) or "none"), flush=True)
        print("x{}: {:.1f} s".format(factor, time.perf_counter() - t0), flush=True)
        del models, memory, sharp, m64
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
