"""model.enqueue_ms: host ms of the encoder's and the prefill's spans
(`model.encode`, `model.prefill`: their kernels enqueued, and waits where
the launch queue is full) a device batch of the window."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["model.encode", "model.prefill"])
