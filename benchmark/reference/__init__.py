"""Plain PyTorch references of the benchmark's configurations.

Each module computes its model the straightforward way, in float32 with TF32
off by default, on complex tensors: FFT, mask, inverse FFT for every data
consistency term, ``torch.nn.functional`` convolutions, autograd for
gradients. Nothing here imports the measured package or JAX, and nothing
reads a tensor the measured package has made: the weights and inputs are the
benchmark's own, handed to both sides.
"""
