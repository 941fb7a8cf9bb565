"""The yardstick's arithmetic: the H100's published peaks, the bytes and
operations of the port's kernels 1 and 2, and the model FLOPs of one item.

Frozen copies, from chip_smoke.py (`bound`, `time_decode`, `time_flash`) and
NVIDIA's H100 SXM data sheet, dense:
989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM, at
the full 700 W (the card's power limit is printed beside every run).  Bytes
count each input read once and each output written once; operations count
what these inputs need (the valid rows of each step, the steps run).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def least_s(nbytes, flops, peak):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak for their type."""
    return max(nbytes / HBM_BPS, flops / peak)


def decode_attention(b, k, h, dh, m, npos):
    """Kernel 1 at one step of one layer, bf16: (bytes, f32 FLOPs).  The
    memory K/V of b items, the npos live text rows of each of b*k beams,
    q and the context, the new row read and written; q.k and p.v over
    [memory; live text] (chip_smoke.py `time_decode`: 31.6 MB at b=32 k=4
    h=12 dh=64 m=257 npos=13)."""
    nbytes = b * h * m * 2 * dh * 2 + b * k * h * npos * 2 * dh * 2 + b * k * h * dh * 2 * 2 \
        + b * k * h * 2 * dh * 2 * 2
    return nbytes, 4 * b * k * h * (m + npos) * dh


def flash_encoder(b, h, s, dh):
    """Kernel 2's encoder entry, bf16: q, k, v read and o written; q.k and
    p.v over all s columns (189 GFLOP at b=32 h=16 s=1201 dh=64)."""
    return 4 * b * h * s * dh * 2, 4 * b * h * s * s * dh


def flash_prefill(b, h, m, tp, dh):
    """Kernel 2's prefill entry with GIT's block mask: memory rows see the
    m memory columns, text row r sees m + its causal prefix."""
    s = m + tp
    seen = m * m + sum(r + 1 for r in range(m, s))
    return 4 * b * h * s * dh * 2, 4 * b * h * seen * dh


def least_decode_attention_s(cfg, b, m, tp, steps, frames=1):
    """Kernel 1's least time over a search of `steps` steps from prefix
    length tp: one call a layer a step, the step at position tp + j
    reading tp + j + 1 live text rows, over a memory of frames x m tokens
    (m a frame's)."""
    k, h = cfg["num_beams"], cfg["num_heads"]
    dh = cfg["hidden_size"] // h
    m = frames * m
    total = 0.0
    for j in range(steps):
        nbytes, flops = decode_attention(b, k, h, dh, m, tp + j + 1)
        total += least_s(nbytes, flops, F32_FLOPS)
    return total * cfg["num_layers"]


def least_flash_s(cfg, b, s, tp, frames=1):
    """Kernel 2's least time for one batch of b rows of `frames` frames:
    the encoder's layers over b x frames images at s tokens and the
    prefill's layers over [frames x s memory; tp text]."""
    he, ht = cfg["encoder_heads"], cfg["num_heads"]
    enc = least_s(*flash_encoder(b * frames, he, s, cfg["encoder_width"] // he), BF16_FLOPS)
    pre = least_s(*flash_prefill(b, ht, frames * s, tp, cfg["hidden_size"] // ht), BF16_FLOPS)
    return enc * cfg["encoder_layers"] + pre * cfg["num_layers"]


def model_flops(cfg, s, tp, steps, frames=1):
    """The model FLOPs of one item of `frames` frames: the ViT at s tokens
    (s - 1 patches and the class token) a frame, the visual projection of
    the memory's m = frames x s tokens, the prefill over [m; tp] with the
    last position's logits, and `steps` beam steps of num_beams rows each,
    with GIT's attention over [memory; live text].  Whatever implements
    them, these are the products the model needs."""
    w, d, v = cfg["encoder_width"], cfg["hidden_size"], cfg["vocab_size"]
    p, ff, k = cfg["patch_size"], cfg["feedforward_size"], cfg["num_beams"]
    m = frames * s
    patch = frames * (2 * (s - 1) * 3 * p * p * w)
    enc = frames * (cfg["encoder_layers"] * (2 * s * w * (3 * w + w + 8 * w) + 4 * s * s * w))
    proj = 2 * m * cfg["visual_feature_size"] * d
    layer = 2 * (4 * d * d + 2 * d * ff)  # per token: q, k, v, out; the FFN
    seen = m * m + sum(m + i + 1 for i in range(tp))
    pre = cfg["num_layers"] * ((m + tp) * layer + 4 * seen * d) + 2 * d * v
    dec = 0
    for j in range(steps):
        dec += k * (cfg["num_layers"] * (layer + 4 * d * (m + tp + j + 1)) + 2 * d * v)
    return patch + enc + proj + pre + dec


def data_ranks(ctx):
    """The data ranks a device batch's rows are split over: the first of the
    traffic's `mesh_shape`, 1 without a mesh."""
    shape = (getattr(ctx, "traffic", None) or {}).get("mesh_shape")
    if shape is None:
        return 1
    return int(shape) if isinstance(shape, int) else int(shape[0])


def span_work(ctx, card=False):
    """[(rows, real items, s tokens a frame, prefix length, steps, frames a
    row)] of the batches dispatched inside the traced span, or None where
    there is none.  The
    span opens and closes with the card drained, so these batches ran in
    it; its settled step count is split evenly over them (exact where the
    batches run equal steps; the steps' positions enter only kernel 1's
    live text rows).  card: each batch's rows and real items on the traced
    card, rank 0's data shard on a mesh (its first rows / data ranks), as
    that card's kernels see them; the whole batch otherwise."""
    span = ctx.span
    if span is None or span.t_close is None or not span.steps:
        return None
    inside = [b for b in ctx.batches if span.t_open <= b["t"] <= span.t_close]
    if not inside or any(b["real"] is None for b in inside):
        return None
    p = ctx.cfg["patch_size"]
    data = data_ranks(ctx) if card else 1
    steps = span.steps / len(inside)
    return [(b["rows"] // data, min(b["real"], b["rows"] // data),
             (b["shape"][0] // p) * (b["shape"][1] // p) + 1,
             b["prefix"].shape[1], steps, b.get("frames", 1)) for b in inside]


KEPT_FLOOR = 0.9  # the share of a kernel's launches the trace must hold


def kernel_device_s(ctx, kernel):
    """The device seconds of a kernel's launches in the traced span: the
    profile's records of kernels named `kernel`, scaled up to the launches
    the port's own counter made in the span where the tracer kept a few
    less than that (each record it keeps is whole).  None where it kept
    fewer than KEPT_FLOOR of them: the tracer loses the kernels of graphs
    captured while it runs, and a handful of records does not stand for
    the rest."""
    prof, launched = ctx.profile, (ctx.span.launched or {}).get(kernel)
    names = [n for n in prof["kernels"] if kernel in n]
    kept = sum(prof["calls"][n] for n in names)
    device = sum(prof["kernels"][n] for n in names)
    if not kept or (launched and kept < KEPT_FLOOR * launched):
        return None
    if launched and launched > kept:
        device *= launched / kept
    return device
