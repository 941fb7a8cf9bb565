"""Offline COCO caption metrics, copies of `gitax.evalcap`: BLEU-1..4,
METEOR (exact and stemmed matching, no synonymy), ROUGE-L and CIDEr-D
(SCST's reward), and `evaluate_on_coco_caption`, which prefers
pycocoevalcap where it is installed."""

from .evaluate import evaluate_on_coco_caption, score_captions
from .cider import CiderD
from .bleu import corpus_bleu
from .rouge import rouge_l
