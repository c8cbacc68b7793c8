"""Sequence sources. So far the synthetic renderer (datasets/synthetic.py);
the dataset loaders come with the system slice."""

from fasttrack_tpu_torch.datasets.synthetic import generate_sequence  # noqa: F401
