"""io_copy_ms.serve: Device ms a slice of the host-to-card and card-to-host copies (memcpy events): the batch I/O of
``Trainer._model_inputs``/``_tensor`` and ``predict_batch``'s host copy."""

from mribench.devtrace import per_slice_ms


def read(ctx):
    return per_slice_ms(ctx, ("memcpy HtoD", "memcpy DtoH"))
