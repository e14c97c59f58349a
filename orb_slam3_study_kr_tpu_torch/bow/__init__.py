"""Binary bag-of-words place recognition (replaces Thirdparty/DBoW2).

Counterpart of ``orb_slam3_study_kr_tpu/bow``: a k-branch, L-depth
vocabulary over 256-bit ORB descriptors trained by hierarchical binary
k-means, a batched tree-descent transform on torch tensors, and a sparse
tf-idf keyframe database with an inverted file.
"""

from orb_slam3_study_kr_tpu_torch.bow.vocabulary import (
    BinaryVocabulary, TreeVocabulary, train_vocabulary, load_dbow2_text,
    save_vocabulary, load_vocabulary)
from orb_slam3_study_kr_tpu_torch.bow.database import KeyframeDatabase
