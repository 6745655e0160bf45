"""Keyframe recognition database: BoW scoring over all keyframes.

JAX replacement for ``KeyFrameDatabase``
(jni/ORB_SLAM2/src/KeyFrameDatabase.cc): the reference keeps an inverted
file (word -> list of keyframes) and walks it per query. With a 10k-word
vocabulary and dense per-keyframe BoW rows, the whole candidate search is a
couple of masked reductions over a (max_kf, n_words) matrix — the "on-device
inverted-index scoring" of the north star (BASELINE.json).

Candidate logic mirrors DetectRelocalizationCandidates / DetectLoopCandidates
(KeyFrameDatabase.cc:84-328): shared-word count gate at 0.8x the max, L1
similarity scoring, covisibility-accumulated scores, keep > 0.75x best.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import struct
from .vocabulary import Vocabulary, bow_vector, l1_score, transform


@struct.dataclass
class KeyframeDatabase:
    bow: jnp.ndarray       # (K, W) f32 — L1-normalized tf-idf row per keyframe
    has_entry: jnp.ndarray  # (K,) bool

    @classmethod
    def create(cls, max_kf: int, n_words: int) -> "KeyframeDatabase":
        return cls(
            bow=jnp.zeros((max_kf, n_words), jnp.float32),
            has_entry=jnp.zeros(max_kf, bool),
        )


@jax.jit
def add_keyframe_bow(
    db: KeyframeDatabase, kf_id: jnp.ndarray, v: jnp.ndarray
) -> KeyframeDatabase:
    """Register a keyframe's BoW vector (KeyFrameDatabase::add)."""
    return db.replace(
        bow=db.bow.at[kf_id].set(v),
        has_entry=db.has_entry.at[kf_id].set(True),
    )


@jax.jit
def erase_keyframe_bow(db: KeyframeDatabase, kf_id: jnp.ndarray) -> KeyframeDatabase:
    return db.replace(
        bow=db.bow.at[kf_id].set(0.0),
        has_entry=db.has_entry.at[kf_id].set(False),
    )


@jax.jit
def _mask_db_valid(db: KeyframeDatabase, kf_valid: jnp.ndarray) -> KeyframeDatabase:
    """Zero the rows of keyframes no longer valid in the map."""
    keep = db.has_entry & kf_valid
    return db.replace(
        bow=jnp.where(keep[:, None], db.bow, 0.0), has_entry=keep
    )


@jax.jit
def build_db_from_keyframes(
    vocab: Vocabulary,
    kf_desc: jnp.ndarray,        # (K, N, 8)
    kf_feat_valid: jnp.ndarray,  # (K, N)
    kf_valid: jnp.ndarray,       # (K,)
) -> KeyframeDatabase:
    """Re-index every valid keyframe in one batched pass (used after the
    vocabulary is (re)trained — the reference parses a fixed ORBvoc.txt once
    and never retrains, but its 1M-word tree was trained offline on a large
    corpus; retraining as the map grows is our substitute for that corpus)."""
    K, N, _ = kf_desc.shape
    words, _ = transform(vocab, kf_desc.reshape(K * N, 8), kf_feat_valid.reshape(K * N))
    rows = jax.vmap(lambda w: bow_vector(vocab, w))(words.reshape(K, N))
    rows = jnp.where(kf_valid[:, None], rows, 0.0)
    return KeyframeDatabase(bow=rows, has_entry=kf_valid)


def _common_words(db: KeyframeDatabase, v: jnp.ndarray) -> jnp.ndarray:
    """(K,) number of vocabulary words shared with the query."""
    return jnp.sum((db.bow > 0) & (v[None, :] > 0), axis=1).astype(jnp.int32)


def _gate_candidates(
    eligible: jnp.ndarray,
    common: jnp.ndarray,
    scores: jnp.ndarray,
    covis_weights: jnp.ndarray,
    min_score: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Shared candidate gating (KeyFrameDatabase.cc:84-328): 0.8x-max common
    words, similarity floor, covisibility-accumulated score over the top-10
    neighbors, keep > 0.75x best accumulated."""
    common = jnp.where(eligible, common, 0)
    max_common = jnp.max(common)
    min_common = (0.8 * max_common).astype(jnp.int32)  # KeyFrameDatabase.cc:129
    pass1 = eligible & (common > min_common) & (scores >= min_score)

    nb_w = jnp.where(pass1[None, :], covis_weights, 0)
    top_w, top_i = jax.lax.top_k(nb_w, min(10, nb_w.shape[1]))  # (K, <=10)
    nb_scores = jnp.where(top_w > 0, scores[top_i], 0.0)
    acc = jnp.where(pass1, scores, 0.0) + jnp.sum(nb_scores, axis=1)

    best_acc = jnp.max(jnp.where(pass1, acc, 0.0))
    keep = pass1 & (acc > 0.75 * best_acc)  # KeyFrameDatabase.cc:185
    return acc, keep


# ---------------------------------------------------------------------------
# Sparse database: per-keyframe (word-id, weight) lists instead of dense
# rows. Required for pre-trained vocabularies at DBoW2 scale (ORBvoc.txt is
# k=10 L=6 -> 1M words: dense rows would be 4 MB/keyframe). A frame's BoW
# vector has at most n_features distinct words, so each row is a compacted
# (S,) id/weight pair; scoring scatters the QUERY dense once (one (W,)
# vector) and gathers it at every row's word ids — O(K*S) work independent
# of vocabulary size.
# ---------------------------------------------------------------------------


@struct.dataclass
class SparseKeyframeDatabase:
    wid: jnp.ndarray       # (K, S) int32 word ids, -1 padding
    wt: jnp.ndarray        # (K, S) f32 L1-normalized tf-idf weights
    has_entry: jnp.ndarray  # (K,)

    @classmethod
    def create(cls, max_kf: int, slots: int) -> "SparseKeyframeDatabase":
        return cls(
            wid=jnp.full((max_kf, slots), -1, jnp.int32),
            wt=jnp.zeros((max_kf, slots), jnp.float32),
            has_entry=jnp.zeros(max_kf, bool),
        )


@jax.jit
def sparse_bow_row(
    vocab: Vocabulary, word_ids: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(N,) leaf word ids (-1 = invalid) -> ((N,) unique word ids with -1
    padding, (N,) L1-normalized tf-idf weights). Duplicate words are merged
    (sort + segment-sum) so min-based L1 scoring sees per-word totals."""
    N = word_ids.shape[0]
    BIG = jnp.int32(2**30)
    w = jnp.where(word_ids >= 0, word_ids.astype(jnp.int32), BIG)
    ws = jnp.sort(w)
    ok = ws < BIG
    is_first = (
        jnp.concatenate([jnp.ones(1, bool), ws[1:] != ws[:-1]]) & ok
    )
    grp = jnp.cumsum(is_first) - 1  # group index per element
    counts = jnp.zeros(N).at[jnp.where(ok, grp, N)].add(1.0, mode="drop")
    uw = (
        jnp.full(N, -1, jnp.int32)
        .at[jnp.where(is_first, grp, N)]
        .set(ws, mode="drop")
    )
    tf = counts * jnp.where(uw >= 0, vocab.word_idf[jnp.maximum(uw, 0)], 0.0)
    s = tf.sum()
    return uw, tf / jnp.maximum(s, 1e-9)


def _dense_query_vec(q_wid: jnp.ndarray, q_wt: jnp.ndarray, n_words: int):
    return (
        jnp.zeros(n_words)
        .at[jnp.where(q_wid >= 0, q_wid, n_words)]
        .set(q_wt, mode="drop")
    )


@partial(jax.jit, static_argnames=("n_words",))
def sparse_scores(
    db: SparseKeyframeDatabase,
    q_wid: jnp.ndarray,
    q_wt: jnp.ndarray,
    n_words: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(scores (K,), common-word counts (K,)) of the query against every row."""
    qv = _dense_query_vec(q_wid, q_wt, n_words)
    g = qv[jnp.maximum(db.wid, 0)] * (db.wid >= 0)  # (K, S)
    scores = 2.0 * jnp.sum(jnp.minimum(g, db.wt), axis=-1)
    common = jnp.sum((g > 0) & (db.wt > 0), axis=-1).astype(jnp.int32)
    return scores, common


@partial(jax.jit, static_argnames=("n_words",))
def query_candidates_sparse(
    db: SparseKeyframeDatabase,
    q_wid: jnp.ndarray,
    q_wt: jnp.ndarray,
    exclude: jnp.ndarray,
    covis_weights: jnp.ndarray,
    min_score: jnp.ndarray,
    n_words: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    scores, common = sparse_scores(db, q_wid, q_wt, n_words)
    eligible = db.has_entry & ~exclude
    return _gate_candidates(eligible, common, scores, covis_weights, min_score)


@jax.jit
def build_sparse_db_from_keyframes(
    vocab: Vocabulary,
    kf_desc: jnp.ndarray,
    kf_feat_valid: jnp.ndarray,
    kf_valid: jnp.ndarray,
) -> SparseKeyframeDatabase:
    K, N, _ = kf_desc.shape
    words, _ = transform(
        vocab, kf_desc.reshape(K * N, 8), kf_feat_valid.reshape(K * N)
    )
    wid, wt = jax.vmap(lambda w: sparse_bow_row(vocab, w))(words.reshape(K, N))
    wid = jnp.where(kf_valid[:, None], wid, -1)
    wt = jnp.where(kf_valid[:, None], wt, 0.0)
    return SparseKeyframeDatabase(wid=wid, wt=wt, has_entry=kf_valid)


@jax.jit
def query_candidates(
    db: KeyframeDatabase,
    v: jnp.ndarray,
    exclude: jnp.ndarray,
    covis_weights: jnp.ndarray,
    min_score: jnp.ndarray = jnp.asarray(0.0),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Shared-word + accumulated-score candidate selection.

    Args:
      v: (W,) query BoW vector.
      exclude: (K,) bool — keyframes that may not be candidates (the query's
        covisibility group for loops — KeyFrameDatabase.cc:95; empty for
        relocalization).
      covis_weights: (K, K) covisibility matrix for score accumulation over
        each candidate's top neighbors (KeyFrameDatabase.cc:152-185).
      min_score: similarity floor (loop detection passes the min covis score,
        DetectLoopCandidates; reloc passes 0).

    Returns (acc_scores (K,), candidate_mask (K,)): keyframes passing all
    gates with their covisibility-accumulated scores.
    """
    eligible = db.has_entry & ~exclude
    common = _common_words(db, v)
    scores = l1_score(db.bow, v)
    return _gate_candidates(eligible, common, scores, covis_weights, min_score)


class BowIndex:
    """Host-side owner of the vocabulary + database, updated per keyframe.

    The analogue of the (vocabulary, KeyFrameDatabase) pair owned by System
    (src/System.cc:124-139). The vocabulary is trained lazily from the first
    keyframes' descriptors (no ORBvoc.txt exists in this environment).
    """

    def __init__(
        self,
        max_kf: int,
        branching: int = 10,
        depth: int = 4,
        vocab: Vocabulary | None = None,
        sparse_slots: int = 1024,
    ):
        """vocab: a pre-trained vocabulary (e.g. vocabulary_from_dbow2 on an
        ORBvoc.txt-format file — the reference loads exactly that at
        src/System.cc:124-129). When its word count exceeds the dense-row
        budget (64k), rows switch to the sparse (word-id, weight) database —
        a 1M-word ORBvoc would need 4 MB/keyframe dense."""
        self.branching = branching
        self.depth = depth
        self.max_kf = max_kf
        self.sparse_slots = sparse_slots
        self.vocab: Vocabulary | None = None
        self.db = None
        self.pretrained = vocab is not None
        self.sparse = False
        self._pending: list = []  # keyframes waiting for vocab training
        if vocab is not None:
            self.branching = vocab.branching
            self.depth = vocab.depth
            self.vocab = vocab
            self.sparse = vocab.n_words > 65536
            self.db = (
                SparseKeyframeDatabase.create(max_kf, sparse_slots)
                if self.sparse
                else KeyframeDatabase.create(max_kf, vocab.n_words)
            )

    @classmethod
    def from_pretrained(
        cls, path: str, max_kf: int, sparse_slots: int = 1024
    ) -> "BowIndex":
        """Build from a DBoW2-format text vocabulary file (ORBvoc.txt)."""
        from .vocabulary import vocabulary_from_dbow2

        return cls(
            max_kf, vocab=vocabulary_from_dbow2(path),
            sparse_slots=sparse_slots,
        )

    @property
    def ready(self) -> bool:
        return self.vocab is not None

    def maybe_train(self, desc: jnp.ndarray, valid: jnp.ndarray, key) -> None:
        """Train the vocabulary from the supplied corpus if not yet trained
        (no-op for a pre-trained vocabulary)."""
        from .vocabulary import train_vocabulary

        if self.vocab is None:
            self.vocab = train_vocabulary(
                desc, valid, key, branching=self.branching, depth=self.depth
            )
            self.db = KeyframeDatabase.create(
                self.max_kf, self.branching**self.depth
            )
            for kf_id, d, dv in self._pending:
                self.add(kf_id, d, dv)
            self._pending = []

    def retrain(
        self,
        kf_desc: jnp.ndarray,
        kf_feat_valid: jnp.ndarray,
        kf_valid: jnp.ndarray,
        key,
    ) -> None:
        """Re-train the vocabulary on the full accumulated keyframe corpus
        and re-index every valid keyframe (vocabulary lifecycle: the initial
        ~4-keyframe vocabulary leaves most words empty and its idf frozen —
        place recognition sharpens considerably with a larger corpus). A
        pre-trained vocabulary is never retrained (the reference parses a
        fixed ORBvoc.txt once); only the rows are rebuilt."""
        from .vocabulary import train_vocabulary

        K, N, _ = kf_desc.shape
        if not self.pretrained:
            self.vocab = train_vocabulary(
                kf_desc.reshape(K * N, 8),
                kf_feat_valid.reshape(K * N) & jnp.repeat(kf_valid, N),
                key, branching=self.branching, depth=self.depth,
            )
        self.reindex(kf_desc, kf_feat_valid, kf_valid)

    def reindex(self, kf_desc, kf_feat_valid, kf_valid) -> None:
        """Rebuild every row from keyframe descriptors in one batched pass."""
        build = (
            build_sparse_db_from_keyframes if self.sparse
            else build_db_from_keyframes
        )
        self.db = build(self.vocab, kf_desc, kf_feat_valid, kf_valid)

    def add(self, kf_id: int, desc: jnp.ndarray, valid: jnp.ndarray) -> None:
        if self.vocab is None:
            self._pending.append((kf_id, desc, valid))
            return
        words, _ = transform(self.vocab, desc, valid)
        kf_id = jnp.asarray(kf_id)
        if self.sparse:
            wid, wt = sparse_bow_row(self.vocab, words)
            S = self.db.wid.shape[1]
            if wid.shape[0] > S:
                # the frame's distinct-word list exceeds the row capacity:
                # truncation underestimates its similarity scores. Size
                # sparse_slots to the feature budget (from_pretrained
                # callers: pass sparse_slots=n_features) to avoid this.
                import warnings

                warnings.warn(
                    f"sparse BoW row truncated: {wid.shape[0]} words > "
                    f"{S} slots; scores for this frame are underestimated",
                    stacklevel=2,
                )
            wid, wt = wid[:S], wt[:S]
            pad = S - wid.shape[0]
            if pad > 0:
                wid = jnp.concatenate([wid, jnp.full(pad, -1, jnp.int32)])
                wt = jnp.concatenate([wt, jnp.zeros(pad)])
            self.db = self.db.replace(
                wid=self.db.wid.at[kf_id].set(wid),
                wt=self.db.wt.at[kf_id].set(wt),
                has_entry=self.db.has_entry.at[kf_id].set(True),
            )
        else:
            v = bow_vector(self.vocab, words)
            self.db = add_keyframe_bow(self.db, kf_id, v)

    def erase(self, kf_id: int) -> None:
        if self.db is None:
            return
        kf_id = jnp.asarray(kf_id)
        if self.sparse:
            self.db = self.db.replace(
                wid=self.db.wid.at[kf_id].set(-1),
                wt=self.db.wt.at[kf_id].set(0.0),
                has_entry=self.db.has_entry.at[kf_id].set(False),
            )
        else:
            self.db = erase_keyframe_bow(self.db, kf_id)

    def mask_valid(self, kf_valid: jnp.ndarray) -> None:
        """Batch erase of every culled keyframe's row
        (KeyFrameDatabase::erase, src/KeyFrameDatabase.cc:60-75): the culls
        happen on device inside the mapping pass, so the host learns about
        them lazily — callers invoke this with the map's kf_valid before
        querying (one fused dispatch, no sync)."""
        if self.db is None:
            return
        if self.sparse:
            keep = self.db.has_entry & kf_valid
            self.db = self.db.replace(
                wid=jnp.where(keep[:, None], self.db.wid, -1),
                wt=jnp.where(keep[:, None], self.db.wt, 0.0),
                has_entry=keep,
            )
        else:
            self.db = _mask_db_valid(self.db, kf_valid)

    def permute(self, kf_map: jnp.ndarray) -> None:
        """Renumber database rows after map compaction: row old -> kf_map[old]
        (-1 rows dropped)."""
        if self.db is None:
            return
        K = self.db.has_entry.shape[0]
        tgt = jnp.where(kf_map >= 0, kf_map, K)
        if self.sparse:
            wid = jnp.full_like(self.db.wid, -1).at[tgt].set(
                self.db.wid, mode="drop"
            )
            wt = jnp.zeros_like(self.db.wt).at[tgt].set(self.db.wt, mode="drop")
            has = jnp.zeros_like(self.db.has_entry).at[tgt].set(
                self.db.has_entry, mode="drop"
            )
            self.db = self.db.replace(wid=wid, wt=wt, has_entry=has)
            return
        bow = jnp.zeros_like(self.db.bow).at[tgt].set(self.db.bow, mode="drop")
        has = jnp.zeros_like(self.db.has_entry).at[tgt].set(
            self.db.has_entry, mode="drop"
        )
        self.db = self.db.replace(bow=bow, has_entry=has)

    # -- query interface (dense/sparse agnostic) -----------------------------
    def query_vector(self, desc: jnp.ndarray, valid: jnp.ndarray):
        """Query representation from frame features: a dense (W,) vector in
        dense mode, a (wid, wt) pair in sparse mode."""
        words, _ = transform(self.vocab, desc, valid)
        if self.sparse:
            return sparse_bow_row(self.vocab, words)
        return bow_vector(self.vocab, words)

    def row_query(self, kf_id: int):
        """The stored row of a keyframe, as a query representation."""
        if self.sparse:
            return (self.db.wid[kf_id], self.db.wt[kf_id])
        return self.db.bow[kf_id]

    def score_rows(self, row_ids, q) -> jnp.ndarray:
        """L1 similarity of query q against the given database rows."""
        row_ids = jnp.asarray(row_ids)
        if self.sparse:
            sub = SparseKeyframeDatabase(
                wid=self.db.wid[row_ids], wt=self.db.wt[row_ids],
                has_entry=self.db.has_entry[row_ids],
            )
            s, _ = sparse_scores(sub, q[0], q[1], self.vocab.n_words)
            return s
        return l1_score(self.db.bow[row_ids], q)

    def candidates(self, q, exclude, covis_weights, min_score=0.0):
        """(acc_scores, keep_mask) for a query against the whole database."""
        ms = jnp.asarray(min_score, jnp.float32)
        if self.sparse:
            return query_candidates_sparse(
                self.db, q[0], q[1], exclude, covis_weights, ms,
                n_words=self.vocab.n_words,
            )
        return query_candidates(self.db, q, exclude, covis_weights, ms)
