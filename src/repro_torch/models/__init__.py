"""The port's language models (``repro.models``'s counterpart).

``torch.utils.checkpoint`` imports ``torch._dynamo`` at its first call,
and that import leaves a reference cycle through the frames that called
it.  Made inside the first train step, the cycle would keep that step's
gradients and old state alive until the cyclic collector ran (tens of
GiB on the card at mixtral's width), so it is imported here, with the
models, where no frame holds a tensor.
"""
import torch._dynamo  # noqa: F401
