"""Hierarchical binary vocabulary (TemplatedVocabulary equivalent).

Counterpart of ``orb_slam3_study_kr_tpu/bow/vocabulary.py``.  Training is
host-side numpy (hierarchical k-means with majority-bit medians and Hamming
assignment), copied from the reference so that the same descriptors and
seed give the same centers.  The transform is a batched tree descent on
torch tensors, one level at a time, with first-index argmin at every level.
Word weights are idf over the training corpus (DBoW2 TF_IDF default).

Two vocabulary classes, both plain dataclasses of tensors:

- ``BinaryVocabulary``: a complete k-ary tree stored per level (the
  session-trained vocabulary);
- ``TreeVocabulary``: a general, possibly unbalanced tree with explicit
  child tables and bit-packed centers, the shape of DBoW2's
  TemplatedVocabulary when loaded from ORBvoc.txt.  Leaves self-loop, so
  the descent is a fixed ``depth``-step gather/argmin.
"""

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class BinaryVocabulary:
    # Level l in [0, L) has k^(l+1) centers:
    # centers[level_offsets[l] + parent*k + j].
    centers: torch.Tensor       # flat (n_internal, 256) uint8
    word_weights: torch.Tensor  # (k^L,) float32
    level_offsets: tuple = ()
    k: int = 10
    L: int = 3

    @property
    def n_words(self):
        return self.k ** self.L

    @property
    def device(self):
        return self.centers.device


def _kmeans_binary(desc, k, iters=8, rng=None):
    """Binary k-means: Hamming assignment, majority-bit centers."""
    n = desc.shape[0]
    if n <= k:
        centers = np.zeros((k, desc.shape[1]), np.uint8)
        centers[:n] = desc
        return centers
    idx = rng.choice(n, k, replace=False)
    centers = desc[idx].copy()
    for _ in range(iters):
        d = (desc[:, None, :] != centers[None, :, :]).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = desc[assign == j]
            if len(sel):
                centers[j] = (sel.mean(0) > 0.5).astype(np.uint8)
    return centers


def train_vocabulary(descriptors, k=10, L=3, seed=0,
                     device="cuda") -> BinaryVocabulary:
    """Hierarchical k-means over (N, 256) uint8 {0,1} descriptors; the
    vocabulary's tensors live on ``device`` ("cuda" raises without a
    card)."""
    device = resolve_device(device, "train_vocabulary(device)")
    if isinstance(descriptors, torch.Tensor):
        descriptors = descriptors.detach().cpu().numpy()
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint8)
    levels = []
    groups = [desc]  # descriptor sets per node of the previous level
    for l in range(L):
        centers_l = np.zeros((k ** (l + 1), desc.shape[1]), np.uint8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = _kmeans_binary(g, k, rng=rng)
            centers_l[gi * k: (gi + 1) * k] = c
            if l < L - 1:
                if len(g):
                    d = (g[:, None, :] != c[None, :, :]).sum(-1)
                    a = d.argmin(1)
                    next_groups.extend(g[a == j] for j in range(k))
                else:
                    next_groups.extend([g] * k)
        levels.append(centers_l)
        groups = next_groups
    flat = np.concatenate(levels, axis=0)
    offsets = []
    off = 0
    for l in range(L):
        offsets.append(off)
        off += k ** (l + 1)
    centers = torch.as_tensor(flat, device=device)
    voc = BinaryVocabulary(
        centers=centers,
        word_weights=torch.ones(k ** L, dtype=torch.float32, device=device),
        level_offsets=tuple(offsets), k=k, L=L)
    # idf weights from the training corpus.
    words = transform(voc, torch.as_tensor(desc, device=device),
                      torch.ones(desc.shape[0], dtype=torch.bool,
                                 device=device))[0]
    counts = np.bincount(words.cpu().numpy(),
                         minlength=k ** L).astype(np.float64)
    idf = np.log(max(desc.shape[0], 1) / np.maximum(counts, 1.0))
    return BinaryVocabulary(
        centers=centers,
        word_weights=torch.as_tensor(idf.astype(np.float32), device=device),
        level_offsets=tuple(offsets), k=k, L=L)


def transform(voc: BinaryVocabulary, desc, valid):
    """(N, 256) descriptors -> (word_id (N,) int64, weight (N,) f32).

    Batched tree descent; invalid slots get weight 0."""
    n = desc.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    ar = torch.arange(voc.k, device=desc.device)
    for l in range(voc.L):
        base = voc.level_offsets[l] + node * voc.k               # (N,)
        cand = voc.centers[base[:, None] + ar[None, :]]          # (N, k, 256)
        ham = (cand != desc[:, None, :]).sum(-1)
        j = torch.argmin(ham, dim=1)                             # first index
        node = node * voc.k + j
    w = voc.word_weights[node] * valid.to(torch.float32)
    return node, w


_PACK_W = [128, 64, 32, 16, 8, 4, 2, 1]
_POPCOUNT8 = [bin(i).count("1") for i in range(256)]


def pack_bits(desc):
    """(..., 256) {0,1} -> (..., 32) packed uint8, big-endian bit order as
    np.packbits."""
    d = desc.to(torch.int32).reshape(*desc.shape[:-1], 32, 8)
    w = torch.tensor(_PACK_W, dtype=torch.int32, device=desc.device)
    return (d * w).sum(-1).to(torch.uint8)


@dataclass(frozen=True)
class TreeVocabulary:
    centers: torch.Tensor      # (n_nodes, 32) packed uint8; root row unused
    children: torch.Tensor     # (n_nodes, k) int32; missing -> self-loop
    child_valid: torch.Tensor  # (n_nodes, k) bool
    node_word: torch.Tensor    # (n_nodes,) int32; -1 for internal nodes
    node_weight: torch.Tensor  # (n_nodes,) float32; leaf idf weight
    k: int = 10
    L: int = 6
    n_words_static: int = 0
    # Actual max leaf depth from the parent chains: the descent runs this
    # many steps.
    depth: int = 0

    @property
    def n_words(self):
        return self.n_words_static

    @property
    def device(self):
        return self.centers.device


def transform_tree(voc: TreeVocabulary, desc, valid):
    """Batched descent of a general tree: (N, 256) -> (word (N,), weight)."""
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)  # root
    dp = pack_bits(desc)                                   # (N, 32)
    popc = torch.tensor(_POPCOUNT8, dtype=torch.int32, device=dev)
    ar = torch.arange(n, device=dev)
    children = voc.children.long()
    for _ in range(voc.depth or voc.L):
        cand = children[node]                              # (N, k)
        cc = voc.centers[cand]                             # (N, k, 32)
        ham = popc[(cc ^ dp[:, None, :]).long()].sum(-1)
        ham = torch.where(voc.child_valid[node], ham, torch.full_like(ham, 512))
        j = torch.argmin(ham, dim=1)
        node = cand[ar, j]
    word = torch.clamp(voc.node_word[node].long(), min=0)
    w = voc.node_weight[node] * valid.to(torch.float32)
    return word, w


def words_and_weights(voc, desc, valid):
    """Dispatch the transform over either vocabulary class."""
    if isinstance(voc, TreeVocabulary):
        return transform_tree(voc, desc, valid)
    return transform(voc, desc, valid)


def load_dbow2_text(path, device="cuda") -> TreeVocabulary:
    """Load a DBoW2 text vocabulary (the ORBvoc.txt format) onto ``device``
    ("cuda" raises without a card).

    Header ``k L scoring weighting``; then one line per non-root node in id
    order (root is 0): ``parent_id is_leaf b0 .. b31 weight``.  Word ids go
    to leaves in file order, as in the reference loader."""
    device = resolve_device(device, "load_dbow2_text(device)")
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    n_nodes = body.shape[0] + 1
    parent = body[:, 0].astype(np.int64)
    is_leaf = body[:, 1] != 0
    desc_bytes = body[:, 2:34].astype(np.uint8)
    weight = body[:, 34].astype(np.float32)

    centers = np.zeros((n_nodes, 32), np.uint8)
    centers[1:] = desc_bytes
    node_ids = np.arange(1, n_nodes, dtype=np.int32)

    # Child tables: group node ids by parent (a stable order keeps the
    # file's child order).
    order = np.argsort(parent, kind="stable")
    p_s = parent[order]
    n_s = node_ids[order]
    starts = np.r_[0, np.flatnonzero(np.diff(p_s)) + 1]
    group_len = np.diff(np.r_[starts, p_s.size])
    rank = np.arange(p_s.size) - np.repeat(starts, group_len)
    if rank.size and rank.max() >= k:
        raise ValueError(
            f"vocabulary node has {rank.max() + 1} children, header k={k}")
    children = np.tile(np.arange(n_nodes, dtype=np.int32)[:, None], (1, k))
    child_valid = np.zeros((n_nodes, k), bool)
    children[p_s, rank] = n_s
    child_valid[p_s, rank] = True

    # Leaf depth by parent-chain climbing; leaves deeper than the header L
    # are rejected rather than truncated to an internal node.
    d = np.ones(node_ids.size, np.int64)
    anc = parent.copy()
    for _ in range(256):
        m = anc > 0
        if not m.any():
            break
        d[m] += 1
        anc = np.where(m, parent[np.maximum(anc, 1) - 1], 0)
    else:
        raise ValueError("vocabulary parent chain does not terminate")
    max_depth = int(d[is_leaf].max()) if is_leaf.any() else 0
    if max_depth > L:
        raise ValueError(
            f"vocabulary leaves at depth {max_depth} exceed header L={L}")

    node_word = np.full(n_nodes, -1, np.int32)
    leaf_ids = node_ids[is_leaf]
    node_word[leaf_ids] = np.arange(leaf_ids.size, dtype=np.int32)
    node_weight = np.zeros(n_nodes, np.float32)
    node_weight[1:] = np.where(is_leaf, weight, 0.0)
    return vocabulary_from_arrays(dict(
        kind="tree", centers=centers, children=children,
        child_valid=child_valid, node_word=node_word, node_weight=node_weight,
        k=k, L=L, n_words=int(leaf_ids.size), depth=max_depth), device=device)


def _np(t):
    return t.detach().cpu().numpy()


def vocabulary_arrays(voc) -> dict:
    """Canonical array form of either vocabulary class (serialization and
    checksum input); the same keys and dtypes as the reference's."""
    if isinstance(voc, TreeVocabulary):
        return dict(
            kind="tree", centers=_np(voc.centers), children=_np(voc.children),
            child_valid=_np(voc.child_valid), node_word=_np(voc.node_word),
            node_weight=_np(voc.node_weight),
            k=voc.k, L=voc.L, n_words=voc.n_words_static, depth=voc.depth)
    return dict(
        kind="complete", centers=_np(voc.centers),
        word_weights=_np(voc.word_weights),
        level_offsets=np.asarray(voc.level_offsets),
        k=voc.k, L=voc.L)


def vocabulary_checksum(voc) -> str:
    """Content digest binding a session to its vocabulary (the role of the
    reference's MD5 of the ORBvoc file), over the decoded content."""
    h = hashlib.md5()
    arrs = vocabulary_arrays(voc)
    for key in sorted(arrs):
        v = arrs[key]
        h.update(key.encode())
        if isinstance(v, np.ndarray):
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(str(v).encode())
    return h.hexdigest()


def vocabulary_from_arrays(z, device="cuda"):
    """Inverse of vocabulary_arrays (also accepts an npz mapping), onto
    ``device`` ("cuda" raises without a card)."""
    device = resolve_device(device, "vocabulary_from_arrays(device)")
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    if str(z["kind"]) == "tree":
        centers = np.asarray(z["centers"])
        if centers.shape[-1] == 256:  # legacy unpacked bits
            centers = np.packbits(centers, axis=-1)
        return TreeVocabulary(
            centers=t(centers, np.uint8), children=t(z["children"], np.int32),
            child_valid=t(z["child_valid"], bool),
            node_word=t(z["node_word"], np.int32),
            node_weight=t(z["node_weight"], np.float32),
            k=int(z["k"]), L=int(z["L"]), n_words_static=int(z["n_words"]),
            depth=int(z["depth"]) if "depth" in z else int(z["L"]))
    return BinaryVocabulary(
        centers=t(z["centers"], np.uint8),
        word_weights=t(z["word_weights"], np.float32),
        level_offsets=tuple(int(o) for o in np.asarray(z["level_offsets"])),
        k=int(z["k"]), L=int(z["L"]))


def save_vocabulary(voc, path):
    """Serialize either vocabulary class to one .npz."""
    np.savez_compressed(path, **vocabulary_arrays(voc))


def load_vocabulary(path, device="cuda"):
    """A vocabulary saved by save_vocabulary, onto ``device`` ("cuda"
    raises without a card)."""
    return vocabulary_from_arrays(np.load(path, allow_pickle=False),
                                  device=device)
