"""The one traffic generator: it reads a traffic file's parameters and the
seed, and makes the cell's inputs.

- Images are JPEGs of synthetic photographs: smooth colour fields with
  texture and a little grain, sized by the file's shape shares, encoded at
  its quality, so that a payload weighs about what a COCO photograph does
  (100-200 KB at 640x480, q90) and decodes like one.  (Replaces the white-noise
  JPEGs of gitax's bench.py, which are far larger and slower to decode.)
- Every seed gets the same multiset of sizes (image shapes, questions an
  image, words a question); the seed draws the pixels, the words and the
  order.  So seeds change the work's content, not its amount.

The TSVs (key, base64 payload; key, questions) carry the reference's offset
indices, as the port's `io.tsv.tsv_writer` writes them.
"""

from __future__ import annotations

import base64
import io
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import vocab as V

# texture (std, pixel levels, at a quarter of the size) and grain (+-, pixel
# levels): together they bring a 640x480 q90 JPEG to ~110 KB, near COCO's
TEXTURE, GRAIN = 30.0, 10


def counts(shares, n):
    """{key: share} -> {key: count} summing to n, by largest remainder (ties
    to the earlier key)."""
    keys = list(shares)
    total = float(sum(shares[k] for k in keys))
    raw = [shares[k] * n / total for k in keys]
    out = [int(np.floor(r)) for r in raw]
    order = sorted(range(len(keys)), key=lambda i: (-(raw[i] - out[i]), i))
    for i in order[:n - sum(out)]:
        out[i] += 1
    return dict(zip(keys, out))


def multiset(shares, n):
    """A list of n keys in the proportions of `shares` (fixed order)."""
    return [k for k, c in counts(shares, n).items() for _ in range(c)]


def shape_key(w, h):
    return "{}x{}".format(w, h)


def parse_shape(key):
    w, h = key.split("x")
    return int(w), int(h)


def _field(rng, h, w, cells, amp):
    """A smooth random field [h, w, 3] f32: a coarse grid of colours resized
    bilinearly."""
    from PIL import Image

    coarse = rng.uniform(-amp, amp, (cells[0], cells[1], 3)).astype(np.float32)
    return np.stack([np.asarray(Image.fromarray(coarse[..., c], mode="F").resize(
        (w, h), Image.BILINEAR)) for c in range(3)], -1)


def photo(rng, w, h):
    """A synthetic photograph, uint8 [h, w, 3]: colour fields and texture
    made at a quarter of the size, resized, plus grain."""
    from PIL import Image

    qh, qw = h // 4, w // 4
    small = rng.uniform(60, 190, 3).astype(np.float32) + _field(rng, qh, qw, (4, 5), 70.0)
    small += _field(rng, qh, qw, (24, 32), 30.0)
    small += rng.normal(0.0, TEXTURE, (qh, qw, 3)).astype(np.float32)
    img = np.asarray(Image.fromarray(np.clip(small, 0, 255).astype(np.uint8)).resize(
        (w, h), Image.BICUBIC), np.int16)
    img = img + rng.integers(-GRAIN, GRAIN + 1, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_b64(arr, quality):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=int(quality))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def payloads(seed, shares, n, quality, stream=0):
    """n base64 JPEGs [(w, h, payload)] in the proportions of `shares`
    ({'640x480': share, ...}), their order drawn from the seed; each image
    drawn from its own child of the seed, so that the threads that make
    them leave the result alone."""
    root = np.random.SeedSequence([int(seed), 0x9B17, int(stream)])
    order = np.random.default_rng(root.spawn(1)[0]).permutation(n)
    shapes = [parse_shape(k) for k in multiset(shares, n)]
    shapes = [shapes[i] for i in order]
    seeds = root.spawn(n + 1)[1:]

    def one(i):
        w, h = shapes[i]
        return w, h, jpeg_b64(photo(np.random.default_rng(seeds[i]), w, h), quality)

    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(one, range(n)))


def caption_rows(seed, n_payloads, repeats):
    """TSV row order for a caption pass: every payload `repeats` times, in an
    order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x7A11])
    return [int(i) for i in rng.permutation(np.repeat(np.arange(n_payloads), repeats))]


def questions(seed, per_image, words, n_images, max_text_len):
    """[[question text, ...] per image]: question counts per image from
    `per_image` ({'3': share, ...}), word counts per question from `words`,
    both fixed multisets; words drawn uniformly from the vocabulary's words.
    Every question is distinct."""
    rng = np.random.default_rng([int(seed), 0x51A])
    vocab = V.tokens()
    lo = V.first_word_id()
    per = [int(k) for k in multiset(per_image, n_images)]
    per = [per[i] for i in rng.permutation(n_images)]
    total = sum(per)
    lens = [int(k) for k in multiset(words, total)]
    lens = [lens[i] for i in rng.permutation(total)]
    if max(lens) > max_text_len - 2:
        raise ValueError("a question of {} words exceeds the prefix's {} tokens".format(
            max(lens), max_text_len - 2))
    seen, flat = set(), []
    for n in lens:
        while True:
            q = " ".join(vocab[i] for i in rng.integers(lo, len(vocab), n))
            if q not in seen:
                break
        seen.add(q)
        flat.append(q)
    out, at = [], 0
    for n in per:
        out.append(flat[at:at + n])
        at += n
    return out


def write_tsv(path, rows):
    """rows of cells -> path, with the two offset indices the reference's TSV
    reader opens (`x.lineidx`: ascii offsets; `x.lineidx.8b`: little-endian
    int64), as gitax_torch/io/tsv.py's tsv_writer writes them."""
    stem = path[:-4] if path.endswith(".tsv") else path
    offset = 0
    with open(path, "wb") as fp, open(stem + ".lineidx", "w") as fi, \
            open(stem + ".lineidx.8b", "wb") as f8:
        for cells in rows:
            line = "\t".join(cells).encode() + b"\n"
            fp.write(line)
            fi.write("{}\n".format(offset))
            f8.write(offset.to_bytes(8, "little"))
            offset += len(line)


def write_image_tsv(path, rows):
    """rows: (key, base64 payload)."""
    write_tsv(path, ((key, b64) for key, b64 in rows))


def write_question_tsv(path, rows):
    """rows: (key, [{'question': ..., 'question_id': ...}])."""
    write_tsv(path, ((key, json.dumps(qs)) for key, qs in rows))
