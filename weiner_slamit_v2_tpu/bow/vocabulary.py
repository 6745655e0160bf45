"""Visual vocabulary: hierarchical binary k-means, batched tree descent.

JAX replacement for DBoW2's ``TemplatedVocabulary``
(jni/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h): the reference ships a
pre-trained k=10, L=6 tree parsed from ORBvoc.txt (~1.08M nodes) and descends
one descriptor at a time (TemplatedVocabulary.h:1225-1266). Here:

* the tree is an *implicit complete K-ary tree* stored as one descriptor
  array per level — children of node i at level l are nodes [i*K, i*K+K) at
  level l+1 — so descent is a batched gather + Hamming argmin per level, all
  N descriptors at once, no pointers;
* training is hierarchical k-means with the bitwise-majority mean (the
  binary-descriptor centroid DBoW2 uses — FORB::meanValue,
  jni/Thirdparty/DBoW2/src/FORB.cpp:31-79), vectorized over all nodes of a
  level simultaneously with segment-sums over unpacked bits;
* because no ORBvoc.txt ships with the reference repo (and this environment
  has no egress), the vocabulary is trained in-framework from dataset
  descriptors; a text loader for the DBoW2 format is provided for parity
  (see load_dbow2_text).

Default size k=10, L=4 (10k words): dense per-keyframe BoW vectors stay small
enough for the database to score every keyframe with one masked matmul-like
reduction, which replaces the inverted index (SURVEY.md §2.2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct


@struct.dataclass
class Vocabulary:
    """Implicit complete K-ary tree of binary descriptor centroids."""

    level_desc: tuple  # tuple of (K^(l+1), 8) uint32 arrays, l = 0..L-1
    level_valid: tuple  # tuple of (K^(l+1),) bool — node actually trained
    word_idf: jnp.ndarray  # (K^L,) f32 idf weight per leaf word
    branching: int = struct.field(static=True, default=10)
    depth: int = struct.field(static=True, default=4)

    @property
    def n_words(self) -> int:
        return self.branching**self.depth


def _unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) float32 of bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], 256).astype(jnp.float32)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(M, 256) bool/float -> (M, 8) uint32."""
    b = (bits > 0.5).astype(jnp.uint32).reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(
        jax.lax.population_count(jnp.bitwise_xor(a, b)), axis=-1
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("branching", "depth", "kmeans_iters"))
def train_vocabulary(
    desc: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    branching: int = 10,
    depth: int = 4,
    kmeans_iters: int = 6,
) -> Vocabulary:
    """Train the hierarchical vocabulary from a descriptor corpus.

    desc: (N, 8) uint32 packed descriptors; valid: (N,) mask.
    All levels are trained with vectorized per-node k-means: the node
    assignment of every descriptor is carried down the tree, so one
    segment-sum per iteration refines *all* nodes of a level at once.
    """
    K = branching
    N = desc.shape[0]
    bits = _unpack_bits(desc)  # (N, 256)

    assign = jnp.zeros(N, jnp.int32)  # node id at current level (root = 0)
    level_desc = []
    level_valid = []

    for lvl in range(depth):
        n_parents = K**lvl
        n_nodes = K**(lvl + 1)
        key, k1 = jax.random.split(key)

        # --- init: for each parent, pick K seed descriptors of that parent
        # (random permutation ranks within each parent's population)
        r = jax.random.uniform(k1, (N,))
        order = jnp.argsort(assign * 2.0 + r)  # group by parent, random inside
        # rank within parent group
        sorted_assign = assign[order]
        first = jnp.searchsorted(sorted_assign, jnp.arange(n_parents))
        rank = jnp.arange(N) - first[jnp.clip(sorted_assign, 0, n_parents - 1)]
        seed_slot = sorted_assign * K + jnp.minimum(rank, K - 1)
        centers = jnp.zeros((n_nodes, 8), jnp.uint32).at[seed_slot].set(
            desc[order]
        )  # later writes win; each slot gets some member descriptor
        seeded = jnp.zeros(n_nodes, bool).at[seed_slot].set(
            valid[order], mode="drop"
        )

        child = jnp.zeros(N, jnp.int32)
        for _ in range(kmeans_iters):
            # distances of each descriptor to its parent's K candidate centers
            cand = centers.reshape(n_parents, K, 8)[assign]  # (N, K, 8)
            cand_ok = seeded.reshape(n_parents, K)[assign]  # (N, K)
            d = _hamming(desc[:, None, :], cand)
            d = jnp.where(cand_ok, d, 10_000)
            child = jnp.argmin(d, axis=1).astype(jnp.int32)
            group = assign * K + child
            # bitwise-majority centroid per group (FORB::meanValue)
            w = valid.astype(jnp.float32)
            sums = jnp.zeros((n_nodes, 256)).at[group].add(bits * w[:, None])
            cnts = jnp.zeros(n_nodes).at[group].add(w)
            maj = sums > 0.5 * jnp.maximum(cnts, 1.0)[:, None]
            has = cnts > 0
            centers = jnp.where(has[:, None], _pack_bits(maj), centers)
            seeded = seeded | has

        assign = assign * K + child
        level_desc.append(centers)
        level_valid.append(seeded)

    # idf weights: log(N / n_i) over the training corpus
    # (TemplatedVocabulary TF_IDF weighting)
    n_words = K**depth
    counts = jnp.zeros(n_words).at[assign].add(valid.astype(jnp.float32))
    n_valid = jnp.maximum(valid.sum(), 1.0)
    idf = jnp.where(counts > 0, jnp.log(n_valid / jnp.maximum(counts, 1.0)), 0.0)

    return Vocabulary(
        level_desc=tuple(level_desc),
        level_valid=tuple(level_valid),
        word_idf=idf,
        branching=K,
        depth=depth,
    )


@jax.jit
def transform(
    vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantize descriptors to leaf words: batched tree descent.

    Returns (word_ids (N,) int32 with -1 for invalid, node_ids (N,) the
    level-2 ancestor used for feature grouping — the analogue of the
    FeatureVector at levelsup (TemplatedVocabulary.h:1134-1201)).
    """
    K = vocab.branching
    node = jnp.zeros(desc.shape[0], jnp.int32)
    for lvl in range(vocab.depth):
        cand = vocab.level_desc[lvl].reshape(-1, K, 8)[node]  # (N, K, 8)
        cand_ok = vocab.level_valid[lvl].reshape(-1, K)[node]
        d = _hamming(desc[:, None, :], cand)
        d = jnp.where(cand_ok, d, 10_000)
        node = node * K + jnp.argmin(d, axis=1).astype(jnp.int32)
    word = jnp.where(valid, node, -1)
    # ancestor at levelsup=... : group level = depth - 2 ancestor (coarser)
    group_ancestor = jnp.where(valid, node // (K * K), -1)
    return word, group_ancestor


@jax.jit
def bow_vector(vocab: Vocabulary, word_ids: jnp.ndarray) -> jnp.ndarray:
    """Dense TF-IDF BoW vector, L1-normalized (the BowVector of DBoW2).

    word_ids: (N,) from transform (-1 ignored). Returns (n_words,) f32.
    """
    n_words = vocab.n_words
    ok = word_ids >= 0
    v = jnp.zeros(n_words).at[jnp.where(ok, word_ids, n_words)].add(
        1.0, mode="drop"
    )
    v = v * vocab.word_idf
    s = v.sum()
    return v / jnp.maximum(s, 1e-9)


def l1_score(v: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: s = 2 * sum_i min(v_i, w_i) for L1-normalized
    vectors — equivalent to the efficient form in L1Scoring::score
    (jni/Thirdparty/DBoW2/src/ScoringObject.cpp:23-70). Batched over leading
    dims of either argument."""
    return 2.0 * jnp.sum(jnp.minimum(v, w), axis=-1)


def load_dbow2_text(path: str, max_nodes: int | None = None):
    """Parse a DBoW2 text vocabulary (header 'k L scoring weighting', then
    one node per line: parent is_leaf d0..d31 weight —
    TemplatedVocabulary.h:1345-1440). Node ids are implicit: root is 0, the
    node on line i gets id i+1, and parents always precede children (DBoW2
    appends children after their parent exists). Returns (k, L, nodes)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents = []
        leaf = []
        descs = []
        weights = []
        for i, line in enumerate(f):
            if max_nodes is not None and i >= max_nodes:
                break
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf.append(int(parts[1]))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    return k, L, {
        "parent": np.asarray(parents, np.int64),
        "is_leaf": np.asarray(leaf, np.int64),
        "desc": np.asarray(descs, np.uint8),
        "weight": np.asarray(weights, np.float64),
    }


def _bytes_to_u32(desc_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32, little-endian within each word.

    Any consistent byte->word packing preserves Hamming distances, which is
    all the vocabulary needs (FORB::distance is a popcount over the whole
    256-bit string — jni/Thirdparty/DBoW2/src/FORB.cpp:81)."""
    b = desc_bytes.astype(np.uint32).reshape(-1, 8, 4)
    return (
        b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    ).astype(np.uint32)


def _u32_to_bytes(desc_u32: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 32) uint8 (inverse of _bytes_to_u32)."""
    d = desc_u32.astype(np.uint32)
    out = np.empty((d.shape[0], 8, 4), np.uint8)
    out[:, :, 0] = d & 0xFF
    out[:, :, 1] = (d >> 8) & 0xFF
    out[:, :, 2] = (d >> 16) & 0xFF
    out[:, :, 3] = (d >> 24) & 0xFF
    return out.reshape(-1, 32)


def vocabulary_from_dbow2(path: str) -> Vocabulary:
    """Embed a DBoW2 text vocabulary (e.g. the standard ORBvoc.txt, k=10
    L=6, ~1.08M nodes) into the implicit-complete-tree :class:`Vocabulary`.

    The file's explicit tree is generally INCOMPLETE (k-means produced fewer
    than k children for some nodes; some leaves sit above the final level).
    Mapping:

    * each node's slot = parent_slot * k + sibling_rank, with ``level_valid``
      masking the slots that have no trained node — descent then simply never
      selects them (transform's cand_ok mask);
    * a leaf at level l < L is propagated down as a single-child chain with
      the same descriptor, so batched descent always terminates at a
      final-level word (word id = final slot);
    * leaf weights become ``word_idf`` (TF_IDF weighting: the stored node
      weight IS the idf — TemplatedVocabulary.h:1345-1440).
    """
    k, L, nodes = load_dbow2_text(path)
    parent = nodes["parent"].astype(np.int64)
    is_leaf = nodes["is_leaf"].astype(bool)
    weight = nodes["weight"].astype(np.float32)
    desc_u32 = _bytes_to_u32(nodes["desc"])
    n = parent.shape[0]
    ids = np.arange(1, n + 1)

    # level of each node (root = 0); parents precede children, so one pass
    # per level suffices
    level = np.full(n + 1, -1, np.int64)
    level[0] = 0
    for l in range(1, L + 1):
        sel = (level[ids] == -1) & (level[parent] == l - 1)
        level[ids[sel]] = l
    if (level[ids] == -1).any():
        bad = int((level[ids] == -1).sum())
        raise ValueError(
            f"{bad} nodes deeper than L={L} or with forward parent refs"
        )

    # sibling rank (order of appearance among nodes sharing a parent)
    order = np.argsort(parent, kind="stable")
    sp = parent[order]
    first = np.searchsorted(sp, sp, side="left")
    rank_sorted = np.arange(n) - first
    rank = np.empty(n, np.int64)
    rank[order] = rank_sorted
    if rank.max(initial=0) >= k:
        raise ValueError("a node has more than k children")

    # implicit slot per node: parent_slot * k + rank
    slot = np.full(n + 1, -1, np.int64)
    slot[0] = 0
    for l in range(1, L + 1):
        sel = level[ids] == l
        slot[ids[sel]] = slot[parent[sel]] * k + rank[sel]

    level_desc = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(L)]
    level_valid = [np.zeros((k ** (l + 1),), bool) for l in range(L)]
    for l in range(1, L + 1):
        sel = level[ids] == l
        s = slot[ids[sel]]
        level_desc[l - 1][s] = desc_u32[sel]
        level_valid[l - 1][s] = True

    # propagate above-final-level leaves down as single-child chains and
    # collect word idf weights at the final level
    word_idf = np.zeros(k**L, np.float32)
    for l in range(1, L + 1):
        sel = is_leaf & (level[ids] == l)
        if not sel.any():
            continue
        cur = slot[ids[sel]]
        d = desc_u32[sel]
        for lc in range(l, L):
            cur = cur * k
            level_desc[lc][cur] = d
            level_valid[lc][cur] = True
        word_idf[cur] = weight[sel]

    return Vocabulary(
        level_desc=tuple(jnp.asarray(a) for a in level_desc),
        level_valid=tuple(jnp.asarray(a) for a in level_valid),
        word_idf=jnp.asarray(word_idf),
        branching=k,
        depth=L,
    )


def save_dbow2_text(vocab: Vocabulary, path: str) -> None:
    """Write the vocabulary in DBoW2's text format (the inverse of
    loadFromTextFile — TemplatedVocabulary.h:1286-1343): header
    'k L scoring weighting' (0 0 = L1_NORM, TF_IDF), then one line per node
    in level order, 'parent is_leaf b0..b31 weight'. Gives round-trip tests
    and lets a vocabulary trained here be consumed by DBoW2 tooling."""
    K, L = vocab.branching, vocab.depth
    idf = np.asarray(vocab.word_idf)
    fid: dict[tuple[int, int], int] = {}
    next_id = 1
    with open(path, "w") as f:
        f.write(f"{K} {L} 0 0\n")
        for l in range(L):
            desc = _u32_to_bytes(np.asarray(vocab.level_desc[l]))
            valid = np.asarray(vocab.level_valid[l])
            for s in np.nonzero(valid)[0]:
                ps = int(s) // K
                pid = 0 if l == 0 else fid.get((l - 1, ps), -1)
                if pid < 0:
                    continue  # orphan slot (untrained parent): skip subtree
                fid[(l, int(s))] = next_id
                leaf = 1 if l == L - 1 else 0
                w = float(idf[int(s)]) if leaf else 0.0
                f.write(
                    f"{pid} {leaf} "
                    + " ".join(str(int(x)) for x in desc[int(s)])
                    + f" {w:.6f}\n"
                )
                next_id += 1
