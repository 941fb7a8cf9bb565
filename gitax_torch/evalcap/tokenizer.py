"""A copy of `gitax.evalcap.tokenizer` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

Caption tokenization for metric computation.

pycocoevalcap uses the Stanford PTBTokenizer (a Java process) and then
drops punctuation.  Offline, gitax approximates the same effective
token stream: lowercase word/contraction tokens, digits kept,
punctuation removed.  When pycocoevalcap is installed the evaluation
path uses its tokenizer instead (gitax.evalcap.evaluate)."""

import re

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")


def tokenize_caption(text: str):
    return _TOKEN_RE.findall(text.lower())
