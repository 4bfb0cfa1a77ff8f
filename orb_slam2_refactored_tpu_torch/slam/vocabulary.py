"""Bag-of-binary-words vocabulary and place-recognition database.

Port of `orb_slam2_refactored_tpu/slam/vocabulary.py` (the analog of
DBoW2's `TemplatedVocabulary` and the reference's `KeyFrameDatabase`): a
frame's ORB descriptors become a tf-idf weighted word vector, and loop or
relocalization candidates are the keyframes whose vectors score highest.

As in the JAX package, there is no vocabulary tree: a descriptor's word is
the Hamming argmin over all W leaf words, and every keyframe's word vector
is a sparse row (ids, counts) of the database, scored against a query that
scatters into one transient dense [W] vector.

On the card the argmin is kernel K1's dense call (`hamming.
masked_best2_gated` with every row and column valid): its best index is the
lowest among equal minima, `jnp.argmin`'s rule. On a CPU tensor the plain
version computes the same argmin in row blocks, with the JAX package's
65,536-word chunks merged by a strict `<`, so no [N, W] matrix of a
million-word vocabulary is ever made.

The database's scatters (word counts, document frequencies) add 0/1 values,
exact in f32 in any order below 2^24, and the query's tf-idf scatter writes
distinct word ids, so the float atomics of `index_add_` on the card change
no result. Padding ids equal W and scatter into an extra slot that is
dropped (the JAX programs' `mode="drop"`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import hamming

# the JAX package's word chunk of `quantize`
WORD_CHUNK = 1 << 16
# descriptor-word pairs of one block of the plain argmin (its popcount
# makes 32 int64 bytes a pair, so a block takes at most 64 MiB)
_BLOCK_PAIRS = 1 << 18


class Vocabulary(NamedTuple):
    words: torch.Tensor   # i32[W,8] leaf centroids (JAX's u32 bits)
    idf: torch.Tensor     # f32[W] inverse document frequency weights

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1)


def _majority_centroid(bits: np.ndarray) -> np.ndarray:
    """bits: [M, 256] -> packed u32[8] majority vote (FORB::meanValue)."""
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _nearest_plain(desc, words):
    """(best index, best distance) of every descriptor over `words`, the
    lowest index among equal minima; row blocks keep the distance matrix
    small."""
    rows = max(1, _BLOCK_PAIRS // max(words.shape[0], 1))
    idx, best = [], []
    for s in range(0, desc.shape[0], rows):
        d = hamming.hamming_matrix(desc[s:s + rows], words)
        b, i = torch.min(d, dim=1)
        idx.append(i.to(torch.int32))
        best.append(b)
    if not idx:
        z = torch.zeros((0,), dtype=torch.int32, device=desc.device)
        return z, z
    return torch.cat(idx), torch.cat(best)


def quantize_plain(voc: Vocabulary, desc):
    """Plain version of `quantize`: the JAX package's chunked loop."""
    W = voc.n_words
    if W <= WORD_CHUNK:
        return _nearest_plain(desc, voc.words)[0]
    n = desc.shape[0]
    best_d = torch.full((n,), hamming.BIG, dtype=torch.int32,
                        device=desc.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=desc.device)
    for s in range(0, W, WORD_CHUNK):
        e = min(s + WORD_CHUNK, W)
        i, dm = _nearest_plain(desc, voc.words[s:e])
        take = dm < best_d
        best_d = torch.where(take, dm, best_d)
        best_i = torch.where(take, i + s, best_i)
    return best_i


def quantize(voc: Vocabulary, desc):
    """Per-descriptor word ids: i32[N,8] -> i32[N] (nearest leaf word).

    CUDA tensors -> one dense K1 launch over all W words; CPU -> plain
    version."""
    if not desc.is_cuda:
        return quantize_plain(voc, desc)
    dev = desc.device
    row_ok = torch.ones((desc.shape[0],), dtype=torch.bool, device=dev)
    col_ok = torch.ones((voc.n_words,), dtype=torch.bool, device=dev)
    return hamming.masked_best2_gated(desc, voc.words, row_ok, col_ok)[0]


def train_vocabulary(descriptors: np.ndarray, n_words: int = 2048,
                     iters: int = 8, seed: int = 0,
                     device=None) -> Vocabulary:
    """k-majority clustering of packed descriptors [M,8] (u32 or i32 bits)
    -> Vocabulary on `device`.

    numpy's `default_rng(seed)` draws in the JAX package's order (`choice`,
    then `integers` for each empty word), and the assignment is the same
    argmin (`quantize`'s), so the words are bit-equal to JAX's. The majority
    vote is a host bit op; idf starts uniform and the database refits it."""
    dev = resolve_device(device)
    desc_u = np.ascontiguousarray(descriptors).view(np.uint32)
    rng = np.random.default_rng(seed)
    M = desc_u.shape[0]
    n_words = min(n_words, M)
    centroids = desc_u[rng.choice(M, n_words, replace=False)].copy()
    desc_dev = torch.from_numpy(desc_u.view(np.int32).copy()).to(dev)
    ones = torch.ones((n_words,), dtype=torch.float32, device=dev)

    bits = _popcount_rows(desc_u)
    for _ in range(iters):
        cents = torch.from_numpy(centroids.view(np.int32).copy()).to(dev)
        a = quantize(Vocabulary(cents, ones), desc_dev).cpu().numpy()
        for w in range(n_words):
            sel = a == w
            if sel.any():
                centroids[w] = _majority_centroid(bits[sel])
            else:
                centroids[w] = desc_u[rng.integers(0, M)]
    return Vocabulary(
        words=torch.from_numpy(centroids.view(np.int32).copy()).to(dev),
        idf=ones)


def load_dbow2_text(path: str, max_words: Optional[int] = None,
                    device=None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the reference's ORBvoc.txt format,
    `TemplatedVocabulary::loadFromTextFile`): header `k L scoring
    weighting`, then one node per line `parent is_leaf b0..b31 weight`.
    Only leaves become words; idf is the weights over their maximum."""
    words = []
    weights = []
    with open(path) as f:
        header = f.readline().split()
        assert len(header) >= 2, "not a DBoW2 text vocabulary"
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            is_leaf = int(parts[1])
            if not is_leaf:
                continue
            desc_bytes = np.asarray([int(x) for x in parts[2:34]], np.uint8)
            words.append(desc_bytes.view(np.uint32))
            weights.append(float(parts[34]))
            if max_words and len(words) >= max_words:
                break
    assert words, "vocabulary contained no leaf words"
    w = np.stack(words)
    idf = np.asarray(weights, np.float32)
    idf = idf / max(idf.max(), 1e-9)
    dev = resolve_device(device)
    return Vocabulary(words=torch.from_numpy(w.view(np.int32).copy()).to(dev),
                      idf=torch.from_numpy(idf).to(dev))


def _word_bytes(voc: Vocabulary) -> np.ndarray:
    return np.ascontiguousarray(voc.words.cpu().numpy()).view(
        np.uint8).reshape(voc.n_words, 32)


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _host_hamming(a_bytes: np.ndarray, b_bytes: np.ndarray) -> np.ndarray:
    """u8[M,32] x u8[N,32] -> i32[M,N] Hamming distances (host numpy; the
    tree is an offline export, not a device path)."""
    x = np.bitwise_xor(a_bytes[:, None, :], b_bytes[None, :, :])
    return _POPCNT8[x].sum(-1, dtype=np.int32)


def save_dbow2_tree(voc: Vocabulary, path: str, k: int = 10,
                    iters: int = 4, seed: int = 0):
    """Write the vocabulary as a hierarchical k-ary tree in the DBoW2 text
    schema (`TemplatedVocabulary::saveToTextFile`: header `k L scoring
    weighting`, then `parent is_leaf b0..b31 weight` a node, ids implicit in
    write order, root omitted), loadable by DBoW2 readers that expect a
    k=10/L=5 style tree. The tree is built over the leaf words by recursive
    k-majority clustering; every leaf keeps its word and idf weight."""
    words = _word_bytes(voc)
    idf = voc.idf.cpu().numpy()
    rng = np.random.default_rng(seed)
    # rows: (parent_id, is_leaf, bytes[32], weight), ids = write order
    rows: list = []
    depth_max = [1]

    def cluster(indices: np.ndarray, parent: int, depth: int):
        depth_max[0] = max(depth_max[0], depth)
        if len(indices) <= k:
            for i in indices:
                rows.append((parent, 1, words[i], float(idf[i])))
            return
        cents = words[rng.choice(indices, k, replace=False)].copy()
        sub = indices if len(indices) <= 4096 else rng.choice(
            indices, 4096, replace=False)
        for _ in range(iters):
            a = np.argmin(_host_hamming(words[sub], cents), axis=1)
            for c in range(k):
                sel = sub[a == c]
                if len(sel):
                    bits = np.unpackbits(words[sel], axis=-1)
                    cents[c] = np.packbits(
                        (bits.sum(0) * 2 >= len(sel)).astype(np.uint8))
        a = np.argmin(_host_hamming(words[indices], cents), axis=1)
        for c in range(k):
            sel = indices[a == c]
            if len(sel) == 0:
                continue
            rows.append((parent, 0, cents[c], 0.0))
            cluster(sel, len(rows), depth + 1)

    cluster(np.arange(voc.n_words), 0, 1)
    L = depth_max[0]
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")  # L1_NORM scoring, TF_IDF weighting
        for parent, leaf, b, w in rows:
            byte_str = " ".join(str(int(x)) for x in b)
            f.write(f"{parent} {leaf} {byte_str} {w:.6f}\n")


def save_dbow2_text(voc: Vocabulary, path: str):
    """Write a flat (depth-1) vocabulary in the DBoW2 text schema, which
    `load_dbow2_text` reads back exactly (leaf order kept). It declares
    k=n_words, L=1; readers that expect a k=10/L=5 tree want
    `save_dbow2_tree`."""
    words = _word_bytes(voc)
    idf = voc.idf.cpu().numpy()
    with open(path, "w") as f:
        f.write(f"{voc.n_words} 1 0 0\n")
        for i in range(voc.n_words):
            byte_str = " ".join(str(int(b)) for b in words[i])
            f.write(f"0 1 {byte_str} {float(idf[i]):.6f}\n")


def word_counts(voc: Vocabulary, desc, valid):
    """Raw word-count vector f32[W] and per-feature word ids (the tf part
    of `TemplatedVocabulary::transform`; idf applies at scoring time)."""
    word = quantize(voc, desc)
    counts = torch.zeros((voc.n_words,), dtype=torch.float32,
                         device=desc.device).index_add_(
        0, word.long(), valid.to(torch.float32))
    return counts, word


def transform(voc: Vocabulary, desc, valid):
    """Descriptors i32[N,8] -> L1-normalized tf-idf word vector f32[W] and
    per-feature word ids."""
    counts, word = word_counts(voc, desc, valid)
    v = counts * voc.idf
    v = v / torch.clamp(v.sum(), min=1e-9)
    return v, word


def l1_similarity(a, b):
    """DBoW2's L1 score for L1-normalized nonnegative vectors: 1 - 0.5 *
    |a - b|_1 == sum(min(a, b)), times 2 for DBoW2's range."""
    return 2.0 * torch.sum(torch.minimum(a, b), dim=-1)


def _scatter_drop(n: int, ids, values):
    """f32[n]: `values` added at `ids`, ids == n dropped."""
    out = torch.zeros((n + 1,), dtype=torch.float32, device=ids.device)
    return out.index_add_(0, ids.reshape(-1).long(), values.reshape(-1))[:n]


class KeyFrameDatabase:
    """Sparse-row place-recognition index over keyframe words.

    Each row stores (word ids i32[T], counts f32[T]), T = min(1024, W),
    padded with id W; idf weighting and L1 normalization apply inside the
    scoring, so `refit_idf` retunes the index to the live corpus without
    recomputing stored rows."""

    def __init__(self, voc: Vocabulary, kf_capacity: int,
                 row_capacity: int = 1024):
        self.voc = voc
        W = voc.n_words
        T = min(row_capacity, W)
        self.row_capacity = T
        dev = voc.words.device
        self.bow_ids = torch.full((kf_capacity, T), W, dtype=torch.int32,
                                  device=dev)
        self.bow_cnt = torch.zeros((kf_capacity, T), dtype=torch.float32,
                                   device=dev)
        self.active = np.zeros(kf_capacity, bool)
        self.idf = voc.idf.clone()

    def compute_bow(self, desc, valid):
        """-> (sparse row (ids i32[T], counts f32[T]), per-feature word ids).

        `jax.lax.top_k` puts equal counts lowest word id first, and counts
        are small integers, so ties are the rule: a stable descending sort
        keeps that order (`torch.topk` promises none among ties on the
        card)."""
        W, T = self.voc.n_words, self.row_capacity
        counts, word = word_counts(self.voc, desc, valid)
        srt = torch.sort(counts, descending=True, stable=True)
        cnt, ids = srt.values[:T], srt.indices[:T]
        ids = torch.where(cnt > 0, ids, torch.full_like(ids, W))
        return (ids.to(torch.int32), cnt), word

    def add(self, kf: int, bow_vec):
        ids, cnt = bow_vec
        self.bow_ids[kf] = ids
        self.bow_cnt[kf] = cnt
        self.active[kf] = True

    def erase(self, kf: int):
        self.bow_ids[kf] = self.voc.n_words
        self.bow_cnt[kf] = 0.0
        self.active[kf] = False

    def clear(self):
        self.bow_ids.fill_(self.voc.n_words)
        self.bow_cnt.zero_()
        self.active[:] = False

    def refit_idf(self):
        """Refit idf to the indexed corpus: idf_w = max(log(N / (1 +
        df_w)), 0)."""
        W = self.voc.n_words
        act = torch.from_numpy(self.active).to(self.bow_ids.device)
        df = _scatter_drop(W, self.bow_ids,
                           ((self.bow_cnt > 0) & act[:, None]).to(
                               torch.float32))
        n = torch.clamp(act.sum().to(torch.float32), min=1.0)
        self.idf = torch.clamp(torch.log(n / (1.0 + df)), min=0.0)

    def score_query(self, bow_vec):
        """Device-side (scores f32[KF], common words i32[KF]) of a sparse
        query against every row."""
        q_ids, q_cnt = bow_vec
        W = self.voc.n_words
        idf = self.idf
        # query -> transient dense tf-idf vector, L1-normalized
        safe_q = torch.clamp(q_ids, 0, W - 1).long()
        q_w = torch.where(q_ids < W, q_cnt * idf[safe_q],
                          torch.zeros_like(q_cnt))
        wq = _scatter_drop(W, q_ids, q_w / torch.clamp(q_w.sum(), min=1e-9))
        # rows: per-entry tf-idf weight, row-normalized
        row_ids, row_cnt = self.bow_ids, self.bow_cnt
        safe = torch.clamp(row_ids, 0, W - 1).long()
        ok = row_ids < W
        r_w = torch.where(ok, row_cnt * idf[safe], torch.zeros_like(row_cnt))
        r_w = r_w / torch.clamp(r_w.sum(-1, keepdim=True), min=1e-9)
        q_at = torch.where(ok, wq[safe], torch.zeros_like(r_w))
        sim = 2.0 * torch.sum(torch.minimum(r_w, q_at), dim=-1)
        q_has = torch.zeros((W + 1,), dtype=torch.int32,
                            device=q_ids.device).scatter_reduce_(
            0, q_ids.long(), (q_cnt > 0).to(torch.int32), "amax")[:W] > 0
        common = torch.sum(ok & (row_cnt > 0) & q_has[safe], dim=-1,
                           dtype=torch.int32)
        return sim, common

    def _score_common(self, query_vec):
        """Scores and common-word counts on the host (one read: counts are
        below 2^24, exact in f32), inactive rows at -1 and 0."""
        s, cw = self.score_query(query_vec)
        both = torch.stack([s, cw.to(torch.float32)]).cpu().numpy()
        s, cw = both[0].copy(), both[1].astype(np.int32)
        s[~self.active] = -1.0
        cw[~self.active] = 0
        return s, cw

    def scores_against_all(self, query_vec) -> np.ndarray:
        """Weighted L1 similarity of `query_vec` against every keyframe."""
        return self._score_common(query_vec)[0]

    def detect_candidates(self, query_vec, exclude: set, min_score: float,
                          max_candidates: int = 10):
        """Score all, drop the excluded set, keep >= max(min_score, 0.75 *
        best), best first."""
        s = self.scores_against_all(query_vec)
        for k in exclude:
            if 0 <= k < len(s):
                s[k] = -1.0
        best = s.max() if len(s) else -1.0
        if best < min_score:
            return []
        th = max(min_score, 0.75 * float(best))
        cands = np.nonzero(s >= th)[0]
        order = np.argsort(-s[cands])
        return [int(c) for c in cands[order][:max_candidates]]

    def detect_candidates_grouped(self, query_vec, exclude: set,
                                  min_score: float, graph,
                                  max_candidates: int = 10):
        """DetectLoopCandidates (`src/KeyFrameDatabase.cc:68-171`):
        shared-word 0.8 gate, covisibility-group accumulated scores, groups
        >= 0.75 x the best kept, each reported by its best-scoring
        keyframe."""
        s, cw = self._score_common(query_vec)
        return self.candidates_from_scores(s, cw, exclude, min_score, graph,
                                           max_candidates)

    def candidates_from_scores(self, s, cw, exclude: set, min_score: float,
                               graph, max_candidates: int = 10):
        """The candidate policy over host (score, common-word) arrays. As in
        the JAX package, the shared-word gate is `>=` and counts group
        members with no common word, where the reference uses `>`."""
        for k in exclude:
            if 0 <= k < len(s):
                s[k] = -1.0
                cw[k] = 0
        if cw.max() == 0:
            return []
        min_common = max(int(0.8 * cw.max()), 1)
        cands = [int(k) for k in
                 np.nonzero((cw >= min_common) & (s >= min_score))[0]]
        if not cands:
            return []
        # accumulate scores over each candidate's covisibility group
        groups = []
        for c in cands:
            group = [c] + [g for g in graph.covis_neighbors(c, top_k=10)
                           if s[g] >= 0]
            acc = float(sum(s[g] for g in group if s[g] > 0))
            best_kf = max(group, key=lambda g: s[g])
            groups.append((acc, best_kf))
        best_acc = max(a for a, _ in groups)
        th = 0.75 * best_acc
        kept = sorted({bk for a, bk in groups if a >= th},
                      key=lambda k: -s[k])
        return kept[:max_candidates]
