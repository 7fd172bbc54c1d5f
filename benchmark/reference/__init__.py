"""The plain reference: NUDFTs, the SENSE model and CG, and the
benchmark's own MRI data, in plain PyTorch. It imports nothing of the
program under test, JAX or the JAX package, and takes nothing that the
program made."""
