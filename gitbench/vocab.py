"""The benchmark's vocabulary and its plain tokenizer and detokenizer.

30522 entries with bert-base-uncased's special ids; every other entry is a
lowercase whole word of consonant-vowel syllables, so that the BERT
tokenizer's decode of ids is the words joined by spaces and a caption's text
maps back to its ids word by word.  The program's tokenizer
(`gitax_torch.tokenization.BertTokenizer`) is built from `tokens()`; the
reference reads text with `to_ids` and `prefix_ids` alone.
"""

from __future__ import annotations

import itertools

SIZE = 30522
SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
CLS, EOS = 101, 102
CONSONANTS = "bcdfghjklmnprstvwz"
VOWELS = "aeiou"


def _words():
    syllables = [c + v for c in CONSONANTS for v in VOWELS]
    for n in itertools.count(2):
        for parts in itertools.product(syllables, repeat=n):
            yield "".join(parts)


def tokens(size=SIZE):
    """The vocabulary in id order."""
    words = _words()
    return [SPECIALS[i] if i in SPECIALS else next(words) for i in range(size)]


def first_word_id():
    """The first id above the special block: question words are drawn from
    here on."""
    return max(SPECIALS) + 1


def index(vocab):
    return {t: i for i, t in enumerate(vocab)}


def detokenize(ids, vocab):
    """BERT's decode with skip_special_tokens: the non-special tokens joined
    by spaces (no entry holds '##' or punctuation, so nothing merges)."""
    return " ".join(vocab[i] for i in ids if i not in SPECIALS)


def to_ids(text, idx):
    """The ids of a text of whole vocabulary words; None when a word is not
    in the vocabulary."""
    try:
        return [idx[w] for w in text.split()]
    except KeyError:
        return None


def prefix_ids(question, idx, max_text_len):
    """[CLS] + the last max_text_len - 2 question ids (the reference's
    prefix rule, inference.py:92-101)."""
    ids = to_ids(question, idx) if question else []
    if ids is None:
        raise ValueError("a question word is not in the vocabulary: {!r}".format(question))
    return [CLS] + ids[-(max_text_len - 2):]
