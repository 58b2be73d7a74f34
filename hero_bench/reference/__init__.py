"""The plain reference: straightforward PyTorch in float32 with TF32
off, no kernels, no cache, no batching.  It imports nothing of the
program and takes only what the benchmark hands both sides (weights it
made, inputs it drew) and the program's outputs, which it judges."""
