"""model.encode_device_ms: device ms of the `model.encode` spans, the mean over
the window: the GPU's global timer read by the two stamps (`span_stamp`,
gitax_torch/csrc/span_clock.cu) the span launches around the encoder's call in
GitModel.build_memory, end less start; beside `vit.encode_ms`."""

from gitbench import program_spans as P


def read(ctx):
    return P.mean_device_ms(ctx, "model.encode")
