"""The port's copies of gitax's framework-free evaluation and data modules
against gitax's: `evalcap` (BLEU-1..4, METEOR, ROUGE-L, CIDEr-D and the
COCO evaluation flow) scores a small corpus exactly as gitax's does, the
code of every function and class is gitax's (AST, docstrings aside), and
`data_prepare` writes gitax's bytes.  `common.hash_sha1` and
`read_to_buffer`, which `data_prepare` needs, are copies too."""

import ast
import base64
import inspect
import json

import pytest

from gitax import common as gx_common
from gitax import data_prepare as gx_prepare
from gitax import inference as gx_inference
from gitax.evalcap import bleu as gx_bleu
from gitax.evalcap import cider as gx_cider
from gitax.evalcap import evaluate as gx_evaluate
from gitax.evalcap import meteor as gx_meteor
from gitax.evalcap import rouge as gx_rouge
from gitax.evalcap import tokenizer as gx_tokenizer
from gitax_torch import common, data_prepare, inference
from gitax_torch.evalcap import bleu, cider, evaluate, meteor, rouge, tokenizer
from gitax_torch.io.tsv import tsv_writer

PAIRS = [(tokenizer, gx_tokenizer), (bleu, gx_bleu), (cider, gx_cider), (rouge, gx_rouge),
         (meteor, gx_meteor), (evaluate, gx_evaluate), (data_prepare, gx_prepare)]

CANDIDATES = {
    "1": "a man riding a wave on top of a surfboard.",
    "2": "two dogs are playing with a frisbee in the grass",
    "3": "a plate of food with broccoli and rice",
    "4": "a red car parked on the side of the road",
    "5": "",
}
REFERENCES = {
    "1": ["A surfer rides a large wave.", "a man on a surfboard riding a wave",
          "Someone surfing on the ocean's waves."],
    "2": ["Two dogs play frisbee on a lawn.", "dogs chasing a frisbee in a field"],
    "3": ["A plate with broccoli, rice and chicken.", "a dish of rice and vegetables"],
    "4": ["a red car parked by the road", "A small red vehicle on a street."],
    "5": ["an empty room", "nothing to see here"],
}


def defs(module):
    """Every top-level function, class and method of a module as an AST
    dump with docstrings removed; the module's constants beside them."""
    tree = ast.parse(inspect.getsource(module))

    def strip(node):
        for n in ast.walk(node):
            body = getattr(n, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:] or [ast.Pass()]
        return node

    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(strip(node))
        elif isinstance(node, (ast.Assign, ast.Import, ast.ImportFrom)):
            out[ast.dump(node)] = True
    return out


@pytest.mark.parametrize("ours,theirs", PAIRS, ids=[m.__name__.split(".")[-1] for m, _ in PAIRS])
def test_copies_hold_gitax_code(ours, theirs):
    assert defs(ours) == defs(theirs)


def test_common_helpers_are_copies():
    for name in ("hash_sha1", "read_to_buffer"):
        assert defs(common)[name] == defs(gx_common)[name], name
    for value in ("abc", [1, "x"], {"k": 2}):
        assert common.hash_sha1(value) == gx_common.hash_sha1(value)


def tok(d):
    return {k: tokenizer.tokenize_caption(v) for k, v in d.items()}


def tok_refs(d):
    return {k: [tokenizer.tokenize_caption(r) for r in v] for k, v in d.items()}


def test_scores_equal_gitax_exactly():
    cands, refs = tok(CANDIDATES), tok_refs(REFERENCES)
    assert bleu.corpus_bleu(cands, refs) == gx_bleu.corpus_bleu(cands, refs)
    assert rouge.rouge_l(cands, refs) == gx_rouge.rouge_l(cands, refs)
    assert cider.CiderD().compute(cands, refs) == gx_cider.CiderD().compute(cands, refs)
    assert meteor.meteor(cands, refs) == gx_meteor.meteor(cands, refs)
    want = gx_evaluate.score_captions(CANDIDATES, REFERENCES)
    got = evaluate.score_captions(CANDIDATES, REFERENCES)
    assert got == want
    assert 0 < got["CIDEr"] and 0 < got["Bleu_4"] < 1 and 0 < got["METEOR"] < 1


def write_tsvs(tmp_path):
    """A result TSV (key, [{'caption'}]) and a gt caption TSV."""
    res, gt = str(tmp_path / "pred.tsv"), str(tmp_path / "gt.tsv")
    tsv_writer([(k, json.dumps([{"caption": v}])) for k, v in CANDIDATES.items()], res)
    tsv_writer([(k, json.dumps([{"caption": r} for r in v])) for k, v in REFERENCES.items()], gt)
    return res, gt


def test_evaluate_on_coco_caption_matches_gitax(tmp_path):
    """The port's CLI function (once refused) and its evalcap give gitax's
    metrics and eval json from the same TSVs."""
    (tmp_path / "port").mkdir()
    (tmp_path / "gitax").mkdir()
    res, gt = write_tsvs(tmp_path / "port")
    got = inference.evaluate_on_coco_caption(res, gt)
    gres, ggt = write_tsvs(tmp_path / "gitax")
    want = gx_inference.evaluate_on_coco_caption(gres, ggt)
    assert got == want
    assert (tmp_path / "port" / "pred.eval.json").read_text() == \
        (tmp_path / "gitax" / "pred.eval.json").read_text()


def test_prepare_coco_test_writes_gitax_bytes(tmp_path):
    """Karpathy-split json + image folder -> the same two TSVs."""
    folder = tmp_path / "val2014"
    folder.mkdir()
    images = []
    for i, split in enumerate(["test", "train", "test", "val"]):
        name = "COCO_val2014_{:012d}.jpg".format(i)
        (folder / name).write_bytes(bytes(range(i, i + 40)))
        images.append({"split": split, "filepath": "val2014", "filename": name, "cocoid": 100 + i,
                       "sentences": [{"raw": "caption {} of {}".format(j, i)} for j in range(3)]})
    (tmp_path / "dataset.json").write_text(json.dumps({"images": images}))
    out = {}
    for label, fn in (("port", data_prepare.prepare_coco_test),
                      ("gitax", gx_prepare.prepare_coco_test)):
        img, cap = tmp_path / label / "img.tsv", tmp_path / label / "cap.tsv"
        fn(str(folder), str(tmp_path / "dataset.json"), str(img), str(cap))
        out[label] = (img.read_bytes(), cap.read_bytes())
    assert out["port"] == out["gitax"]
    rows = out["port"][0].decode().splitlines()
    assert [r.split("\t")[0] for r in rows] == ["100", "102"]
    assert base64.b64decode(rows[1].split("\t")[1]) == bytes(range(2, 42))


def test_nick_names_match_gitax():
    class Synset(object):
        def __init__(self, name):
            self._name = name

        def name(self):
            return self._name

    for name in ("ice_cream.n.01", "dog.n.01", "great_white_shark.n.01"):
        assert data_prepare.get_nick_name(Synset(name)) == gx_prepare.get_nick_name(Synset(name))
    assert data_prepare.NICK_NAME_OVERRIDES == gx_prepare.NICK_NAME_OVERRIDES
