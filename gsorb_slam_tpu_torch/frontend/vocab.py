"""Bag-of-binary-words vocabulary, the DBoW2 equivalent (counterpart of
``gsorb_slam_tpu/frontend/vocab.py``).

The vocabulary tree of ``Thirdparty/DBoW2`` (``TemplatedVocabulary.h``,
``FORB.cpp``) as flat numpy arrays; word lookup is an L-step descent on
the descriptors' device (gather the children's descriptors, batched
Hamming argmin) over all of a frame's descriptors at once. Reads and
writes the text format of the reference's ``ORBvoc.txt``
(``System::LoadVocabulary``, ``src/System.cc:86-96``).
:func:`default_vocabulary` loads this package's own copy of the JAX
package's ``assets/ORBvoc_synth.txt``. :func:`build_vocabulary` trains a
tree (hierarchical binary k-medians, on the host in numpy);
``scripts/train_vocab.py`` is the tool that writes the packaged copy.

Scoring: L1, DBoW2's default in ORB-SLAM2:
``s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1`` over L1-normalized tf-idf vectors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.frontend.matcher import popcount32


@dataclasses.dataclass
class Vocabulary:
    k: int  # branching factor
    L: int  # depth
    children: np.ndarray  # [n_nodes, k] int32 node ids (-1 = none)
    node_desc: np.ndarray  # [n_nodes, 8] uint32
    word_id: np.ndarray  # [n_nodes] int32 (-1 for non-leaves)
    weights: np.ndarray  # [n_words] float32 idf weights
    n_words: int

    def _tables(self, device: torch.device):
        """The tree's arrays as tensors on ``device``, made once per device."""
        cache = self.__dict__.setdefault("_device_tables", {})
        if device not in cache:
            cache[device] = (
                torch.as_tensor(self.children.astype(np.int64), device=device),
                torch.as_tensor(np.ascontiguousarray(self.node_desc, np.uint32).view(np.int32),
                                device=device),
                torch.as_tensor(self.word_id.astype(np.int64), device=device),
                torch.as_tensor(self.weights.astype(np.float32), device=device),
            )
        return cache[device]

    def transform(self, descriptors: torch.Tensor, valid: torch.Tensor):
        """Descriptors ``[N, 8]`` -> (word ids [N], tf-idf weights [N])."""
        wid, w, _nodes = self.transform_with_nodes(descriptors, valid)
        return wid, w

    def transform_with_nodes(self, descriptors: torch.Tensor, valid: torch.Tensor,
                             levels_up: int = 1):
        """The descent, also returning the tree node ``levels_up`` above the
        leaf: DBoW2's direct index (``FeatureVector``). Returns (word ids
        [N], tf-idf weights [N], node ids [N]); invalid rows get -1, 0, -1."""
        children, node_desc, word_id, weights = self._tables(descriptors.device)
        n = descriptors.shape[0]
        node = torch.zeros(n, dtype=torch.int64, device=descriptors.device)
        direct = torch.zeros_like(node)
        stop_level = max(self.L - max(levels_up, 0), 0)
        d64 = descriptors.to(torch.int64)
        for lvl in range(self.L):
            ch = children[node]  # [N, k]
            has = ch >= 0
            cd = node_desc[torch.clamp(ch, min=0)].to(torch.int64)  # [N, k, 8]
            ham = popcount32(d64[:, None, :] ^ cd).sum(-1)
            d = torch.where(has, ham, torch.full_like(ham, 1 << 20))
            best = torch.argmin(d, dim=1)
            nxt = torch.gather(ch, 1, best[:, None])[:, 0]
            node = torch.where(nxt >= 0, nxt, node)
            if lvl + 1 == stop_level:
                direct = node
        wid = word_id[node]
        w = torch.where((wid >= 0) & valid, weights[torch.clamp(wid, min=0)],
                        torch.zeros((), device=wid.device))
        minus = torch.full_like(wid, -1)
        return torch.where(valid, wid, minus), w, torch.where(valid, direct, minus)

    def bow_vector(self, descriptors: torch.Tensor, valid: torch.Tensor) -> dict[int, float]:
        """Sparse L1-normalized tf-idf BoW vector (a host dict)."""
        wid, w = self.transform(descriptors, valid)
        vec: dict[int, float] = {}
        for i, t in zip(wid.cpu().numpy(), w.cpu().numpy()):
            if i >= 0 and t > 0:
                vec[int(i)] = vec.get(int(i), 0.0) + float(t)
        norm = sum(abs(v) for v in vec.values()) or 1.0
        return {k_: v / norm for k_, v in vec.items()}


def score_l1(v1: dict[int, float], v2: dict[int, float]) -> float:
    """DBoW2 L1 score in [0, 1] (``ScoringObject.cpp`` L1Scoring)."""
    s = 0.0
    for k_, x in v1.items():
        y = v2.get(k_)
        if y is not None:
            s += abs(x) + abs(y) - abs(x - y)
    return 0.5 * s


def _unpack_bits(desc_u32: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits."""
    b = desc_u32.astype(np.uint32)
    bits = ((b[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)
    return bits.reshape(len(desc_u32), 256)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, 256] bits -> [N, 8] uint32 (the inverse of :func:`_unpack_bits`)."""
    w = bits.reshape(-1, 8, 32).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(axis=2).astype(np.uint32)


def build_vocabulary(
    descriptors: np.ndarray | torch.Tensor,
    k: int = 6,
    L: int = 3,
    seed: int = 0,
    iters: int = 4,
) -> Vocabulary:
    """Hierarchical binary k-medians (the DBoW2 training algorithm) over
    ``descriptors`` ``[N, 8]``: ``np.uint32``, or the frontend's ``int32``
    words (a tensor or an array), which carry the same bits.

    The centres are drawn by ``np.random.default_rng(seed).choice`` in the
    recursion's depth-first order, so a seed gives the same tree as the JAX
    package's ``build_vocabulary``."""
    if isinstance(descriptors, torch.Tensor):
        descriptors = descriptors.detach().cpu().numpy()
    descriptors = np.ascontiguousarray(descriptors)
    if descriptors.dtype == np.int32:
        descriptors = descriptors.view(np.uint32)
    rng = np.random.default_rng(seed)
    bits = _unpack_bits(descriptors)

    nodes_desc = [np.zeros(256, np.uint8)]  # root placeholder
    children: list[list[int]] = [[]]
    word_of: list[int] = [-1]
    leaf_counts: list[int] = []

    def cluster(idx: np.ndarray, depth: int, parent: int) -> None:
        if depth == L or len(idx) <= 1:
            # leaf: the parent becomes a word
            word_of[parent] = len(leaf_counts)
            leaf_counts.append(len(idx))
            return
        kk = min(k, len(idx))
        centers = bits[rng.choice(idx, kk, replace=False)].astype(np.float32)
        for _ in range(iters):
            assign = np.abs(bits[idx][:, None, :] - centers[None]).sum(-1).argmin(1)
            for c in range(kk):
                sel = idx[assign == c]
                if len(sel):
                    centers[c] = (bits[sel].mean(0) > 0.5).astype(np.float32)
        assign = np.abs(bits[idx][:, None, :] - centers[None]).sum(-1).argmin(1)
        for c in range(kk):
            sel = idx[assign == c]
            if len(sel) == 0:
                continue
            node_id = len(nodes_desc)
            nodes_desc.append((centers[c] > 0.5).astype(np.uint8))
            children.append([])
            word_of.append(-1)
            children[parent].append(node_id)
            cluster(sel, depth + 1, node_id)

    cluster(np.arange(len(bits)), 0, 0)

    ch = np.full((len(nodes_desc), k), -1, np.int32)
    for i, c in enumerate(children):
        ch[i, : len(c)] = c[:k]
    # idf weights
    counts = np.maximum(np.array(leaf_counts, np.float32), 1.0)
    weights = np.maximum(np.log(len(bits) / counts), 1e-3)
    return Vocabulary(
        k=k, L=L, children=ch, node_desc=_pack_bits(np.stack(nodes_desc)),
        word_id=np.array(word_of, np.int32), weights=weights.astype(np.float32),
        n_words=len(leaf_counts),
    )


def save_orbvoc_text(voc: Vocabulary, path: str) -> None:
    """Write the DBoW2 text format (``TemplatedVocabulary::saveToTextFile``):
    header ``k L scoring weighting``, then one line per non-root node,
    parents before children (breadth first): ``parent_id is_leaf b0..b31
    weight``, node ids renumbered in that order."""
    order: list[int] = []
    fid = {0: 0}
    queue = [0]
    while queue:
        nid = queue.pop(0)
        for c in voc.children[nid]:
            if c >= 0:
                fid[int(c)] = len(order) + 1
                order.append(int(c))
                queue.append(int(c))
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L} 0 0\n")
        for nid in order:
            rows, _cols = np.nonzero(voc.children == nid)
            par = int(rows[0]) if len(rows) else 0
            is_leaf = 1 if voc.word_id[nid] >= 0 else 0
            by = voc.node_desc[nid].astype("<u4").view(np.uint8)
            w = float(voc.weights[voc.word_id[nid]]) if is_leaf else 0.0
            f.write(f"{fid[par]} {is_leaf} " + " ".join(str(int(b)) for b in by) + f" {w}\n")


def load_orbvoc_text(path: str) -> Vocabulary:
    """Load the DBoW2 text vocabulary of ORB-SLAM2's ``ORBvoc.txt``: header
    ``k L s1 s2``, then one node per line, ``parent_id is_leaf b0..b31
    weight``, in creation order."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaves, descs, wts = [], [], [], []
        for line in f:
            p = line.split()
            if len(p) < 35:
                continue
            parents.append(int(p[0]))
            leaves.append(int(p[1]))
            descs.append([int(x) for x in p[2:34]])
            wts.append(float(p[34]))
    n = len(parents) + 1  # + root
    children = np.full((n, k), -1, np.int32)
    ccount = np.zeros(n, np.int32)
    node_bytes = np.zeros((n, 32), np.uint8)
    word_id = np.full(n, -1, np.int32)
    weights = []
    for i, par in enumerate(parents):
        nid = i + 1
        children[par, ccount[par]] = nid
        ccount[par] += 1
        node_bytes[nid] = np.array(descs[i], np.uint8)
        if leaves[i]:
            word_id[nid] = len(weights)
            weights.append(wts[i])
    return Vocabulary(k=k, L=L, children=children, node_desc=node_bytes.view("<u4").reshape(n, 8),
                      word_id=word_id, weights=np.array(weights, np.float32),
                      n_words=len(weights))


DEFAULT_VOCABULARY_PATH = os.path.join(os.path.dirname(__file__), "..", "assets",
                                       "ORBvoc_synth.txt")
_DEFAULT_VOCAB_CACHE: Optional[Vocabulary] = None


def default_vocabulary() -> Optional[Vocabulary]:
    """The packaged synthetic-domain ORB vocabulary (this package's
    ``assets/ORBvoc_synth.txt``), the role of the reference's
    ``Vocabulary/ORBvoc.txt`` loaded at System start; None if the file is
    missing."""
    global _DEFAULT_VOCAB_CACHE
    if _DEFAULT_VOCAB_CACHE is None and os.path.exists(DEFAULT_VOCABULARY_PATH):
        _DEFAULT_VOCAB_CACHE = load_orbvoc_text(DEFAULT_VOCABULARY_PATH)
    return _DEFAULT_VOCAB_CACHE
