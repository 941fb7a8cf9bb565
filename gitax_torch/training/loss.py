"""Label-smoothed cross-entropy, the counterpart of
`gitax.training.loss`: the reference SmoothLabelCrossEntropyLoss
(decoder.py:620-671) and its shift/mask training protocol
(decoder.py:939-959).

Per row, the KL divergence between the smoothed one-hot target and the
log-softmax of the logits, summed over the classes and averaged over the
rows `need_predict` selects, the constant ``t*log(t)`` entropy term of
the smoothed target included (torch F.kl_div semantics), for loss-value
parity with the reference.

On a data-parallel mesh the mean is over the global batch, as in gitax's
SPMD program: each data rank divides its own rows' sum by the valid rows
of all ranks (`group`, an all-reduce of the count), so the gradients sum
over the ranks to the one-card gradient, whatever each rank's count.
"""

from __future__ import annotations

import math

import torch

from ..parallel.comm import all_reduce


def _xlogx(x: float) -> float:
    return x * math.log(x) if x > 0 else 0.0


def smooth_label_cross_entropy(logits, targets, valid_mask, eps=0.1, group=None):
    """logits [N, V] (any float dtype; upcast to f32 first, as
    decoder.py:639 does), targets [N] int, valid_mask [N] bool.  Returns
    the mean over valid rows of sum_v t_v * (log t_v - logprob_v), t the
    smoothed one-hot.  group: a data group; the sum over these rows is
    then divided by the valid rows summed over the group (this rank's
    share of the global mean)."""
    logits = logits.float()
    v = logits.shape[-1]
    logprobs = torch.log_softmax(logits, dim=-1)
    on = 1.0 - eps
    off = eps / (v - 1)
    # sum_v t_v * log t_v (constant per row), with 0 log 0 = 0: eps=0 is
    # the plain cross-entropy (gitax's jnp.log(0) makes it NaN)
    entropy = torch.tensor(_xlogx(on) + (v - 1) * _xlogx(off), dtype=torch.float32,
                           device=logits.device)
    # sum_v t_v * logprob_v = off * sum_v logprob_v + (on - off) * logprob_target
    lp_target = logprobs.gather(1, targets[:, None].long())[:, 0]
    cross = off * logprobs.sum(dim=-1) + (on - off) * lp_target
    per_row = entropy - cross
    valid = valid_mask.float()
    count = torch.clamp(all_reduce(valid.sum(), group), min=1.0)
    return (per_row * valid).sum() / count


def caption_loss(logits, caption_tokens, need_predict, eps=0.1, padding_idx=0, group=None):
    """Teacher-forcing loss: logits[:, :-1] against tokens[:, 1:] on the
    rows where the shifted need_predict == 1 (decoder.py:939-959).
    Targets at masked positions become padding_idx, as in the reference
    (decoder.py:940-942); the mask excludes them anyway.  group: see
    `smooth_label_cross_entropy`."""
    feat = logits[:, :-1]
    target = caption_tokens[:, 1:]
    mask = need_predict[:, 1:] == 1
    target = torch.where(mask, target, torch.full_like(target, padding_idx))
    b, t, v = feat.shape
    return smooth_label_cross_entropy(feat.reshape(b * t, v), target.reshape(-1),
                                      mask.reshape(-1), eps, group)
