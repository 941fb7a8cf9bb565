"""model.prefill_device_ms: device ms of the `model.prefill` spans, the mean over
the window: the GPU's global timer read by the two stamps (`span_stamp`,
gitax_torch/csrc/span_clock.cu) the span launches around the prefill's call in
GitModel.generate, end less start; beside `textual.prefill_ms`."""

from gitbench import program_spans as P


def read(ctx):
    return P.mean_device_ms(ctx, "model.prefill")
