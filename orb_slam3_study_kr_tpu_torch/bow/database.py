"""Keyframe recognition database (replaces src/KeyFrameDatabase.cc).

Counterpart of ``orb_slam3_study_kr_tpu/bow/database.py``, host-side numpy
copied from it: sparse tf-idf BoW vectors plus an inverted file (word ->
keyframe list), so a query costs its word count and candidate set, not
n_words x n_keyframes.  Only the vocabulary transform runs on the
vocabulary's torch device.

Candidate selection is the reference's (KeyFrameDatabase.cc:432-517): only
keyframes sharing enough words compete (>= 0.8x the best common-word
count), scores accumulate over covisibility groups, and candidates within
0.75x of the best accumulated score survive.
"""

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.bow.vocabulary import words_and_weights


def sparse_bow(voc, desc, valid):
    """L1-normalized sparse BoW: (words int64 sorted unique, weights f32)."""
    def dev(a):
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        return torch.as_tensor(a, device=voc.device)

    w_ids, w = words_and_weights(voc, dev(desc), dev(valid))
    w_ids = w_ids.cpu().numpy()
    w = w.cpu().numpy().astype(np.float64)
    keep = w > 0
    words, inv = np.unique(w_ids[keep], return_inverse=True)
    vals = np.zeros(words.size, np.float64)
    np.add.at(vals, inv, w[keep])
    s = vals.sum()
    if s > 0:
        vals /= s
    return words.astype(np.int64), vals.astype(np.float32)


def sparse_l1_score(w1, v1, w2, v2):
    """DBoW2 L1 score between L1-normalized sparse vectors:
    score = 0.5 * sum_shared (|a| + |b| - |a - b|)  (== 1 - 0.5|v1-v2|_1)."""
    shared, i1, i2 = np.intersect1d(w1, w2, assume_unique=True,
                                    return_indices=True)
    if shared.size == 0:
        return 0.0
    a = v1[i1].astype(np.float64)
    b = v2[i2].astype(np.float64)
    return float(0.5 * np.sum(np.abs(a) + np.abs(b) - np.abs(a - b)))


@dataclass
class KeyframeDatabase:
    voc: object  # BinaryVocabulary | TreeVocabulary
    vectors: dict = field(default_factory=dict)  # kf_id -> (words, weights)
    inv_file: dict = field(default_factory=lambda: defaultdict(list))

    def add(self, kf_id, desc, valid):
        words, vals = sparse_bow(self.voc, desc, valid)
        self.vectors[kf_id] = (words, vals)
        for w in words:
            self.inv_file[int(w)].append(kf_id)

    def erase(self, kf_id):
        entry = self.vectors.pop(kf_id, None)
        if entry is not None:
            for w in entry[0]:
                lst = self.inv_file.get(int(w))
                if lst is not None:
                    try:
                        lst.remove(kf_id)
                    except ValueError:
                        pass

    def clear(self):
        self.vectors.clear()
        self.inv_file.clear()

    def _shared_words(self, q_words, exclude):
        """Inverted-file pass: keyframe -> common-word count."""
        common = defaultdict(int)
        for w in q_words:
            for kf in self.inv_file.get(int(w), ()):
                common[kf] += 1
        for k in exclude:
            common.pop(k, None)
        # Stale inverted-file entries (erased KFs) are filtered by vectors.
        return {k: c for k, c in common.items() if k in self.vectors}

    def detect_candidates(self, desc, valid, exclude=(), covisibility=None,
                          n_best=3, min_common_ratio=0.8, retain_ratio=0.75):
        """Loop/merge candidates for a query image (DetectNBestCandidates).

        covisibility: optional callable kf_id -> iterable of covisible kf ids
        used for group score accumulation.  Returns up to n_best kf ids,
        best first."""
        q_words, q_vals = sparse_bow(self.voc, desc, valid)
        common = self._shared_words(q_words, set(exclude))
        if not common:
            return []
        max_common = max(common.values())
        th = max(min_common_ratio * max_common, 1)
        ids = np.array([k for k, c in common.items() if c >= th])
        if ids.size == 0:
            return []
        scores = np.array([
            sparse_l1_score(q_words, q_vals, *self.vectors[int(k)])
            for k in ids])
        # Accumulate scores over covisibility groups.
        acc = scores.copy()
        if covisibility is not None:
            id_to_pos = {int(k): i for i, k in enumerate(ids)}
            for i, k in enumerate(ids):
                for nb in covisibility(int(k)):
                    j = id_to_pos.get(int(nb))
                    if j is not None and j != i:
                        acc[i] += scores[j]
        best = acc.max()
        order = np.argsort(-acc)
        out = [int(ids[i]) for i in order if acc[i] >= retain_ratio * best]
        return out[:n_best]

    def detect_relocalization_candidates(self, desc, valid, n_best=5):
        return self.detect_candidates(desc, valid, exclude=(),
                                      n_best=n_best, retain_ratio=0.5)
