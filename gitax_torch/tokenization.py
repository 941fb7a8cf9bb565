"""BERT WordPiece tokenizer (bert-base-uncased compatible).

A copy of `gitax.tokenization`, which needs no framework: the port keeps
its own so that nothing of the gitax package is imported where the port
runs.  `tests/test_torch_port_ops.py` holds its encodes and decodes equal
to gitax's.  Basic tokenization (whitespace, punctuation, CJK,
lower-casing and accent stripping) then greedy longest-match WordPiece,
as defined by the original BERT repo; ids and decodes equal HuggingFace's
slow BertTokenizer for the same vocab.

`encode_prefix` builds a VQA question prefix.  `build_tiny_vocab` makes a
small deterministic vocabulary with bert-base-uncased's special-token
ids, for runs without a vocab file.  `BertTokenizer.bert_base_uncased`
looks for the vocab file where gitax's does (`VOCAB_SEARCH_PATHS`, then a
HuggingFace hub cache).
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Iterable, List, Optional, Sequence

# bert-base-uncased special token ids
PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103

VOCAB_SEARCH_PATHS = (
    "aux_data/tokenizer/bert-base-uncased-vocab.txt",
    "aux_data/tokenizer/vocab.txt",
    os.path.expanduser("~/.cache/gitax/bert-base-uncased-vocab.txt"),
)


def _hf_cache_vocab_paths():
    """vocab.txt files inside a HuggingFace hub cache for
    bert-base-uncased, when one exists locally."""
    import glob

    base = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    pattern = os.path.join(base, "hub", "models--*bert-base-uncased*", "snapshots", "*",
                           "vocab.txt")
    return sorted(glob.glob(pattern))


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def _whitespace_tokenize(text):
    text = text.strip()
    return text.split() if text else []


class BasicTokenizer(object):
    """Whitespace/punctuation splitting with optional lowercasing and
    accent stripping: the pre-pass of BERT tokenization."""

    def __init__(self, do_lower_case=True, never_split=()):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text):
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        tokens = []
        for token in _whitespace_tokenize(text):
            if token in self.never_split:
                tokens.append(token)
                continue
            if self.do_lower_case:
                token = self._strip_accents(token.lower())
            tokens.extend(self._split_on_punc(token))
        return _whitespace_tokenize(" ".join(tokens))

    @staticmethod
    def _clean_text(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text):
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_on_punc(token):
        pieces = []
        current = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordpieceTokenizer(object):
    """Greedy longest-match-first sub-word tokenization."""

    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text):
        output = []
        for token in _whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                output.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens = []
            while start < len(chars):
                end = len(chars)
                cur_substr = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur_substr = substr
                        break
                    end -= 1
                if cur_substr is None:
                    is_bad = True
                    break
                sub_tokens.append(cur_substr)
                start = end
            output.extend([self.unk_token] if is_bad else sub_tokens)
        return output


class BertTokenizer(object):
    """Offline bert-base-uncased-compatible tokenizer: `__call__` and
    `encode` with `add_special_tokens`, `truncation` and `max_length`,
    and `decode(ids, skip_special_tokens=...)`, as HuggingFace's."""

    def __init__(self, vocab_tokens: Sequence[str], do_lower_case: bool = True):
        self.vocab = {tok: i for i, tok in enumerate(vocab_tokens)}
        self.ids_to_tokens = list(vocab_tokens)
        self.do_lower_case = do_lower_case
        self.pad_token, self.unk_token = "[PAD]", "[UNK]"
        self.cls_token, self.sep_token, self.mask_token = "[CLS]", "[SEP]", "[MASK]"
        self._special_tokens = (
            self.pad_token, self.unk_token, self.cls_token,
            self.sep_token, self.mask_token,
        )
        # literal special-token strings in input text stay atomic, as in
        # HuggingFace (pre-split on them, passed as never_split)
        self.basic_tokenizer = BasicTokenizer(
            do_lower_case=do_lower_case, never_split=self._special_tokens
        )
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in self._special_tokens) + ")"
        )
        for t in self._special_tokens:
            if t not in self.vocab:
                raise ValueError("vocab is missing special token {}".format(t))

    @classmethod
    def from_vocab_file(cls, vocab_file: str, do_lower_case: bool = True):
        with open(vocab_file, "r", encoding="utf-8") as fp:
            tokens = [line.rstrip("\n") for line in fp]
        while tokens and tokens[-1] == "":
            tokens.pop()
        return cls(tokens, do_lower_case=do_lower_case)

    @classmethod
    def bert_base_uncased(cls, search_paths: Optional[Iterable[str]] = None):
        candidates = list(search_paths or VOCAB_SEARCH_PATHS)
        if search_paths is None:
            candidates += _hf_cache_vocab_paths()
        for p in candidates:
            if os.path.isfile(p):
                return cls.from_vocab_file(p)
        raise FileNotFoundError(
            "bert-base-uncased vocab.txt not found; place it at one of: {}".format(
                ", ".join(VOCAB_SEARCH_PATHS)))

    @property
    def vocab_size(self):
        return len(self.vocab)

    @property
    def pad_token_id(self):
        return self.vocab[self.pad_token]

    @property
    def unk_token_id(self):
        return self.vocab[self.unk_token]

    @property
    def cls_token_id(self):
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self):
        return self.vocab[self.sep_token]

    @property
    def mask_token_id(self):
        return self.vocab[self.mask_token]

    @property
    def all_special_ids(self):
        return {self.vocab[t] for t in self._special_tokens}

    # -- encode ------------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        out = []
        # "[SEP]" in the text maps to the single special token, not to
        # '[', 'sep', ']' wordpieces
        for chunk in self._special_split.split(text):
            if not chunk:
                continue
            if chunk in self.vocab and chunk in self._special_tokens:
                out.append(chunk)
                continue
            for token in self.basic_tokenizer.tokenize(chunk):
                out.extend(self.wordpiece_tokenizer.tokenize(token))
        return out

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        return [self.ids_to_tokens[i] for i in ids]

    def encode(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            limit = max_length - 2 if (truncation and max_length) else None
            ids = [self.cls_token_id] + ids[:limit] + [self.sep_token_id]
        elif truncation and max_length:
            ids = ids[:max_length]
        return ids

    def __call__(self, text, padding="do_not_pad", truncation=False,
                 add_special_tokens=True, max_length=None):
        del padding  # only 'do_not_pad' is used by GIT's pipelines
        kw = dict(add_special_tokens=add_special_tokens, max_length=max_length,
                  truncation=truncation)
        if isinstance(text, (list, tuple)):
            return {"input_ids": [self.encode(t, **kw) for t in text]}
        return {"input_ids": self.encode(text, **kw)}

    # -- decode ------------------------------------------------------------
    def convert_tokens_to_string(self, tokens):
        return " ".join(tokens).replace(" ##", "").strip()

    @staticmethod
    def clean_up_tokenization(out_string):
        return (
            out_string.replace(" .", ".")
            .replace(" ?", "?")
            .replace(" !", "!")
            .replace(" ,", ",")
            .replace(" ' ", "'")
            .replace(" n't", "n't")
            .replace(" 'm", "'m")
            .replace(" 's", "'s")
            .replace(" 've", "'ve")
            .replace(" 're", "'re")
        )

    def decode(self, ids, skip_special_tokens=False, clean_up_tokenization_spaces=True):
        # skip_special_tokens=False by default, as HuggingFace's: [UNK]
        # renders as the literal text "[UNK]"
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            special = self.all_special_ids
            ids = [i for i in ids if i not in special]
        text = self.convert_tokens_to_string(self.convert_ids_to_tokens(ids))
        if clean_up_tokenization_spaces:
            text = self.clean_up_tokenization(text)
        return text


def encode_prefix(tokenizer, text: str, max_text_len: int = 40):
    """[CLS] + the last (max_text_len - 2) question tokens: the
    reference's prefix rule (inference.py:92-101), as gitax's
    `encode_prefix`."""
    payload = tokenizer(
        text,
        padding="do_not_pad",
        truncation=True,
        add_special_tokens=False,
        max_length=max_text_len,
    )["input_ids"]
    if len(payload) > max_text_len - 2:
        payload = payload[-(max_text_len - 2):]
    return [tokenizer.cls_token_id] + payload


def build_tiny_vocab(words=(), size=30522):
    """Deterministic test vocabulary with bert-base-uncased's special-token
    ids ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103).

    `words` are inserted as whole-word entries after the specials; the rest
    of the table is filled with single characters, '##'-suffix pieces and
    numbered filler to reach `size` entries.
    """
    tokens = ["[PAD]"] + ["[unused{}]".format(i) for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'\"-")
    tokens += chars
    tokens += ["##" + c for c in chars]
    seen = set(tokens)
    for w in words:
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    i = 0
    while len(tokens) < size:
        t = "[fill{}]".format(i)
        i += 1
        if t not in seen:
            tokens.append(t)
    return tokens[:size]
