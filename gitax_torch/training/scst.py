"""SCST (self-critical sequence training, Rennie et al. 2017), the
counterpart of `gitax.training.scst`.  The reference ships only a
disabled skeleton (decoder.py:804-813 raises NotImplementedError;
forward_one_scst at decoder.py:879-914 sketches the flow).  Per step:

  device:  a greedy baseline decode and N sampled decodes per image
           (`GitModel.generate`, greedy mode and the sampled beam search
           with num_return_sequences N, on the plain decode step, as
           gitax's rollouts run it);
  host:    CIDEr-D rewards against the ground-truth captions (`evalcap`);
  device:  the REINFORCE update: teacher-forced log-probs of the sampled
           sequences weighted by (reward - greedy baseline), one AdamW
           step.

`generate` runs under `torch.inference_mode()`, and its outputs are
inference tensors, which a graph cannot save for its backward: the
sampled sequences reach the update through the host, as gitax's do
(`np.asarray(sampled_seqs)`, scst.py:138-149).  The sampling draws come
from the caller's `torch.Generator` through `decode.beam.gumbel_noise`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..decode.beam import BeamSearchConfig
from ..evalcap.cider import CiderD
from ..evalcap.tokenizer import tokenize_caption
from ..models.git import GitModel
from .trainer import TrainState, apply_gradients


def sequence_logprob_loss(model: GitModel, images, seqs, advantages, eos_id=102,
                          dtype=torch.float32):
    """-mean(advantage * sum log p(sampled token)), teacher-forced.

    seqs: [N, L] sampled sequences starting with [CLS]; tokens after the
    first EOS are excluded (the EOS itself is scored)."""
    logits = model.forward_logits(images, seqs, dtype=dtype)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = seqs[:, 1:]
    tok_lp = lp.gather(-1, targets[..., None])[..., 0]
    # valid: up to and including the first EOS in the generated part
    is_eos = (targets == eos_id).int()
    after_eos = torch.cumsum(is_eos, dim=1) - is_eos
    mask = (after_eos == 0).float()
    seq_lp = (tok_lp * mask).sum(dim=1)
    return -(advantages * seq_lp).mean()


class ScstTrainer(object):
    def __init__(self, model: GitModel, tokenizer, num_samples: int = 5, max_steps: int = 40,
                 temperature: float = 1.0, dtype=torch.float32, sos_id: int = 101,
                 eos_id: int = 102):
        self.model = model
        self.tokenizer = tokenizer
        self.num_samples = num_samples
        self.max_steps = max_steps
        self.dtype = dtype
        self.sos_id, self.eos_id = sos_id, eos_id
        self.cider = CiderD()
        self.sample_cfg = BeamSearchConfig(
            num_beams=1,
            per_node_beam_size=2,
            max_steps=max_steps,
            do_sample=True,
            temperature=temperature,
            top_p=1.0,
            eos_id=eos_id,
        )

    def _decode(self, seq) -> str:
        return self.tokenizer.decode([int(t) for t in seq], skip_special_tokens=True)

    def _rewards(self, captions: List[str], gts: Sequence[Sequence[str]]):
        cands = {str(i): tokenize_caption(c) for i, c in enumerate(captions)}
        refs = {str(i): [tokenize_caption(r) for r in g] for i, g in enumerate(gts)}
        _, scores = self.cider.compute(cands, refs)
        return np.asarray(scores, np.float32)

    def rollout(self, images, gt_captions: Sequence[Sequence[str]], rng: torch.Generator):
        """The greedy baseline and the sampled sequences of images [B, ...]
        and their CIDEr-D rewards.  Returns (sampled sequences [B*N, L]
        int64 numpy, advantages [B*N] f32 numpy, sample rewards [B*N],
        greedy rewards [B])."""
        b, n = images.shape[0], self.num_samples
        greedy_seqs, _ = self.model.generate(images, mode="greedy", max_steps=self.max_steps,
                                             dtype=self.dtype, sos_id=self.sos_id)
        sampled_seqs, _ = self.model.generate(images, beam=self.sample_cfg, dtype=self.dtype,
                                              sos_id=self.sos_id, num_return_sequences=n,
                                              rng=rng)
        seqs = sampled_seqs.cpu().numpy()
        greedy_caps = [self._decode(s) for s in greedy_seqs.cpu().numpy()]
        sample_caps = [self._decode(s) for s in seqs]
        baseline = self._rewards(greedy_caps, gt_captions)
        gts_rep = [gt_captions[i // n] for i in range(b * n)]
        sample_r = self._rewards(sample_caps, gts_rep)
        advantages = sample_r - np.repeat(baseline, n)
        return seqs, advantages, sample_r, baseline

    def update(self, state: TrainState, images, seqs, advantages) -> torch.Tensor:
        """One AdamW step on -mean(advantage * sum log p) of the host
        sequences [B*N, L] over images [B, ...] (each repeated N times);
        returns the loss."""
        dev = images.device
        loss = sequence_logprob_loss(
            state.model, images.repeat_interleave(self.num_samples, dim=0),
            torch.from_numpy(np.asarray(seqs)).long().to(dev),
            torch.from_numpy(np.asarray(advantages, np.float32)).to(dev), self.eos_id,
            self.dtype)
        loss.backward()
        apply_gradients(state)
        return loss.detach()

    def step(self, state: TrainState, images, gt_captions: Sequence[Sequence[str]],
             rng: torch.Generator):
        """One SCST update.  images [B, ...] on the model's device;
        gt_captions: per image, its reference captions; rng: the sampling
        generator, on the images' device.  Returns (state, metrics)."""
        seqs, advantages, sample_r, baseline = self.rollout(images, gt_captions, rng)
        loss = self.update(state, images, seqs, advantages)
        return state, {
            "loss": float(loss),
            "reward_sample": float(sample_r.mean()),
            "reward_greedy": float(baseline.mean()),
        }
