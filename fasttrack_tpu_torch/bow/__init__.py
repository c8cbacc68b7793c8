"""Bag-of-binary-words place recognition (the reference's Thirdparty/DBoW2).

Port of fasttrack_tpu/bow: the vocabulary (flat word centroids quantized
by the fused Hamming top-K kernel at K = 1 on the card, or the shipped
two-level tree quantized on the host) with tf-idf weights, and the
keyframe database: the inverted index and the candidate grouping on the
host, mirroring the reference's KeyFrameDatabase.
"""

from fasttrack_tpu_torch.bow.vocabulary import (  # noqa: F401
    Vocabulary,
    l1_score,
    train_vocabulary,
)
from fasttrack_tpu_torch.bow.database import KeyFrameDatabase  # noqa: F401
