"""Command line of the port (``python -m ktransformers_tpu_torch.cli``;
counterpart of ktransformers_tpu/cli, on argparse)."""
