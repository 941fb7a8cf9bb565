"""A copy of `gitax.evalcap.evaluate` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

COCO caption evaluation orchestration (reference inference.py:277-313).

Prefers pycocoevalcap/pycocotools when installed (full metric set incl.
METEOR/SPICE via Java); otherwise falls back to gitax's native offline
scorers (BLEU-1..4, ROUGE-L, CIDEr-D)."""

from __future__ import annotations

import json
import logging
import os.path as op

from .bleu import corpus_bleu
from .cider import CiderD
from .meteor import meteor
from .rouge import rouge_l
from .tokenizer import tokenize_caption


def score_captions(candidates: dict, references: dict):
    """candidates: image_id -> caption string;
    references: image_id -> [caption strings].  Returns metric dict
    (BLEU-1..4, METEOR, ROUGE-L, CIDEr-D — 4 of the 5 COCO metrics;
    SPICE needs the Java scene-graph pipeline and stays external)."""
    cand_tok = {k: tokenize_caption(v) for k, v in candidates.items()}
    ref_tok = {k: [tokenize_caption(r) for r in v] for k, v in references.items()}
    bleus = corpus_bleu(cand_tok, ref_tok)
    rl, _ = rouge_l(cand_tok, ref_tok)
    cd, _ = CiderD().compute(cand_tok, ref_tok)
    mt, _ = meteor(cand_tok, ref_tok)
    result = {"Bleu_{}".format(i + 1): b for i, b in enumerate(bleus)}
    result["METEOR"] = mt
    result["ROUGE_L"] = rl
    result["CIDEr"] = cd
    return result


def _load_res_json(res_file_coco):
    with open(res_file_coco) as fp:
        preds = json.load(fp)
    return {str(p["image_id"]): p["caption"] for p in preds}


def _load_label_json(label_file):
    with open(label_file) as fp:
        gt = json.load(fp)
    refs = {}
    for ann in gt["annotations"]:
        refs.setdefault(str(ann["image_id"]), []).append(ann["caption"])
    return refs


def evaluate_on_coco_caption(res_file, label_file, outfile=None):
    if not outfile:
        outfile = op.splitext(res_file)[0] + ".eval.json"

    if res_file.endswith(".tsv"):
        from ..inference import convert_tsv_to_coco_format

        res_file_coco = op.splitext(res_file)[0] + "_coco_format.json"
        convert_tsv_to_coco_format(res_file, res_file_coco)
    else:
        res_file_coco = res_file

    if label_file.endswith(".tsv"):
        from ..inference import iter_caption_to_json
        from ..io.tsv import TSVFile

        json_caption = op.splitext(label_file)[0] + ".coco_ann.json"
        iter_caption_to_json(TSVFile(label_file), json_caption)
        label_file = json_caption

    try:
        from pycocotools.coco import COCO
        from pycocoevalcap.eval import COCOEvalCap

        coco = COCO(label_file)
        coco_res = coco.loadRes(res_file_coco)
        coco_eval = COCOEvalCap(coco, coco_res)
        coco_eval.params["image_id"] = coco_res.getImgIds()
        coco_eval.evaluate()
        result = coco_eval.eval
        provenance = {"scorer": "pycocoevalcap"}
    except ImportError:
        logging.info("pycocoevalcap not installed; using gitax native scorers "
                     "(BLEU/METEOR/ROUGE_L/CIDEr; no SPICE)")
        candidates = _load_res_json(res_file_coco)
        references = _load_label_json(label_file)
        missing = set(candidates) - set(references)
        assert not missing, "predictions without references: {}".format(
            sorted(missing)[:5]
        )
        candidates = {k: candidates[k] for k in references if k in candidates}
        references = {k: references[k] for k in candidates}
        result = score_captions(candidates, references)
        # native METEOR is a documented variant (exact/stem matching
        # only — no WordNet synonymy/paraphrase tables, evalcap/
        # meteor.py); mark the emitted json so a downstream reader
        # cannot mistake variant-METEOR for jar-METEOR (VERDICT r2)
        provenance = {"scorer": "native", "METEOR_variant": "no-synonymy"}

    with open(outfile, "w") as fp:
        # provenance keys ride in the FILE only; the returned dict stays
        # all-numeric for metric consumers
        json.dump(dict(result, **provenance), fp, indent=4)
    logging.info("metrics: %s", result)
    return result
