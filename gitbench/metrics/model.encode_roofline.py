"""model.encode_roofline: the encoder's least time over its device time,
in percent.  The FLOPs of the `images` of the window's `model.encode`
device spans (each image the patch embedding and the encoder's layers at
S = tokens / frames, as `peaks.model_flops` counts a frame) over those
spans' device seconds (their stamps, the GPU's global timer) times the
H100's 989 TFLOP/s bf16 dense peak.  Nothing to read where the spans carry
no `images` or no device times."""

from gitbench import peaks
from gitbench import program_spans as P


def image_flops(cfg, s):
    """One image's encoder FLOPs at s tokens (s - 1 patches and the class
    token), as `peaks.model_flops` counts them."""
    w, p = cfg["encoder_width"], cfg["patch_size"]
    patch = 2 * (s - 1) * 3 * p * p * w
    return patch + cfg["encoder_layers"] * (2 * s * w * (3 * w + w + 8 * w) + 4 * s * s * w)


def read(ctx):
    recs = [r for r in P.window(ctx, "model.encode") or () if r.device_ms is not None]
    if not recs or any("images" not in r.attrs or "frames" not in r.attrs for r in recs):
        return None
    flops = sum(r.attrs["images"] * image_flops(ctx.cfg, r.attrs["tokens"] // r.attrs["frames"])
                for r in recs)
    device_s = sum(r.device_ms for r in recs) / 1e3
    return 100.0 * flops / (device_s * peaks.BF16_FLOPS) if device_s > 0 else None
