"""Port parity for `slam/vocabulary.py`: vocabulary training, quantization,
the keyframe database's rows, scores, idf and candidate policy, and the
DBoW2 text files, against the JAX package's functions on the same inputs
(numpy seeds). Words, word ids and BoW rows are exact; scores and idf are
held to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.slam import vocabulary as jv
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.slam import vocabulary as tv

torch.set_num_threads(1)


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def clustered_desc(rng, n, n_centres=40, flips=24):
    """Descriptors around `n_centres` random centres, `flips` random bits
    flipped each (a crude stand-in for ORB's appearance clusters)."""
    centres = rand_desc(rng, n_centres)
    out = centres[rng.integers(0, n_centres, n)].copy()
    bits = np.unpackbits(out.view(np.uint8), axis=-1)
    for i in range(n):
        bits[i, rng.integers(0, 256, flips)] ^= 1
    return np.packbits(bits, axis=-1).view(np.uint32)


def t_desc(d):
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32).copy())


def port_voc(jvoc):
    return convert.vocabulary_from_numpy(
        {"words": np.asarray(jvoc.words), "idf": np.asarray(jvoc.idf)},
        "cpu")


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(3)
    desc = clustered_desc(rng, 2000)
    return desc, jv.train_vocabulary(desc, n_words=128, iters=3, seed=0)


@pytest.mark.parametrize("kind", ["clustered", "random"])
def test_train_vocabulary_bit_equal(kind, trained):
    if kind == "clustered":
        desc, ref = trained
    else:  # near-uniform distances: ties in the assignment are common
        desc = rand_desc(np.random.default_rng(4), 1500)
        ref = jv.train_vocabulary(desc, n_words=128, iters=3, seed=0)
    out = tv.train_vocabulary(desc, n_words=128, iters=3, seed=0,
                              device="cpu")
    assert out.words.dtype == torch.int32
    np.testing.assert_array_equal(
        convert.vocabulary_to_numpy(out)["words"], np.asarray(ref.words))
    np.testing.assert_array_equal(out.idf.numpy(), np.asarray(ref.idf))


def test_train_vocabulary_empty_words_draw_like_jax():
    """More words than distinct descriptors: empty words redraw from the
    generator, in JAX's order."""
    rng = np.random.default_rng(5)
    desc = np.repeat(rand_desc(rng, 20), 3, axis=0)
    ref = jv.train_vocabulary(desc, n_words=50, iters=2, seed=7)
    out = tv.train_vocabulary(desc, n_words=50, iters=2, seed=7,
                              device="cpu")
    np.testing.assert_array_equal(
        convert.vocabulary_to_numpy(out)["words"], np.asarray(ref.words))


def test_quantize_equal(trained):
    desc, jvoc = trained
    q = clustered_desc(np.random.default_rng(6), 500)
    ref = np.asarray(jv.quantize(jvoc, jnp.asarray(q)))
    out = tv.quantize(port_voc(jvoc), t_desc(q))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_quantize_chunked_equal():
    """W = 70,000 takes the 65,536-word chunks and their strict `<` merge:
    a word repeated across the chunk boundary must resolve to the first
    chunk, a nearest word only in the second chunk must win."""
    rng = np.random.default_rng(8)
    W = 70_000
    words = rand_desc(rng, W)
    words[65_536 + 100] = words[100]       # an exact tie across chunks
    q = rand_desc(rng, 24)
    q[0] = words[100]                       # tie: word 100
    q[1] = words[65_536 + 2000]             # only in the second chunk
    q[2] = words[W - 1]
    jvoc = jv.Vocabulary(words=jnp.asarray(words),
                         idf=jnp.ones((W,), jnp.float32))
    ref = np.asarray(jv.quantize(jvoc, jnp.asarray(q)))
    out = tv.quantize(port_voc(jvoc), t_desc(q)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[0] == 100 and out[1] == 65_536 + 2000 and out[2] == W - 1


def _dbs(jvoc, cap=12):
    return jv.KeyFrameDatabase(jvoc, cap), tv.KeyFrameDatabase(
        port_voc(jvoc), cap)


def test_compute_bow_exact(trained):
    """Row ids and counts exact, equal counts in JAX's top_k order (lower
    word id first), padding id W; per-feature words equal."""
    _, jvoc = trained
    jdb, tdb = _dbs(jvoc)
    rng = np.random.default_rng(9)
    for n in (300, 40):
        d = clustered_desc(rng, n)
        valid = rng.random(n) < 0.8
        (jids, jcnt), jw = jdb.compute_bow(jnp.asarray(d), jnp.asarray(valid))
        (ids, cnt), w = tdb.compute_bow(t_desc(d), torch.from_numpy(valid))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert ids.dtype == torch.int32 and int(ids.max()) == jvoc.n_words


def _filled(jvoc, rng, n_rows=9, cap=12):
    """Both databases with the same rows added (row 3 then erased), and the
    base descriptors the rows vary."""
    jdb, tdb = _dbs(jvoc, cap)
    base = clustered_desc(rng, 300)
    for k in range(n_rows):
        d = base.copy()
        d[rng.random(300) < 0.3 + 0.05 * k] = clustered_desc(rng, 1)[0]
        valid = rng.random(300) < 0.9
        jv_, _ = jdb.compute_bow(jnp.asarray(d), jnp.asarray(valid))
        tv_, _ = tdb.compute_bow(t_desc(d), torch.from_numpy(valid))
        jdb.add(k, jv_)
        tdb.add(k, tv_)
    jdb.erase(3)
    tdb.erase(3)
    return jdb, tdb, base


def test_score_query_and_refit_idf(trained):
    _, jvoc = trained
    rng = np.random.default_rng(10)
    jdb, tdb, base = _filled(jvoc, rng)
    for refit in (False, True):
        if refit:
            jdb.refit_idf()
            tdb.refit_idf()
            np.testing.assert_allclose(tdb.idf.numpy(), np.asarray(jdb.idf),
                                       rtol=0, atol=1e-6)
        q = base.copy()
        q[rng.random(300) < 0.5] = rand_desc(rng, 1)[0]
        valid = np.ones(300, bool)
        jq, _ = jdb.compute_bow(jnp.asarray(q), jnp.asarray(valid))
        tq, _ = tdb.compute_bow(t_desc(q), torch.from_numpy(valid))
        js, jc = jdb.score_query(jq)
        ts, tc = tdb.score_query(tq)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc.dtype == torch.int32
        s, cw = tdb._score_common(tq)
        assert s[3] == -1.0 and cw[3] == 0 and s.dtype == np.float32


def test_clear_and_erase(trained):
    _, jvoc = trained
    jdb, tdb, _ = _filled(jvoc, np.random.default_rng(11))
    np.testing.assert_array_equal(tdb.bow_ids.numpy(), np.asarray(jdb.bow_ids))
    np.testing.assert_array_equal(tdb.bow_cnt.numpy(), np.asarray(jdb.bow_cnt))
    np.testing.assert_array_equal(tdb.active, jdb.active)
    jdb.clear()
    tdb.clear()
    np.testing.assert_array_equal(tdb.bow_ids.numpy(), np.asarray(jdb.bow_ids))
    assert not tdb.active.any() and float(tdb.bow_cnt.abs().sum()) == 0.0


class _Graph:
    def __init__(self, neighbors=None):
        self.neighbors = neighbors or {}

    def covis_neighbors(self, kf, top_k=10):
        return list(self.neighbors.get(kf, []))[:top_k]


# (scores, common words, min_score, covisibility), the counterparts of
# tests/test_vocab_solvers.py:225-265 and a few more
POLICY_CASES = {
    "min_score_at_floor": ([0.30, 0.2999], [5, 5], 0.30, {}),
    "min_score_two_at_floor": ([0.30, 0.30], [5, 5], 0.30, {}),
    # min_common = int(0.8 * 10) = 8: cw 8 passes (>=), 7 fails
    "shared_word_gate_ge": ([0.50, 0.45, 0.44], [10, 8, 7], 0.1, {}),
    # a group member with no common word still counts toward its group
    "member_without_common_word": ([0.5, 0.3, 0.4, 0.45], [9, 9, 0, 9], 0.1,
                                   {1: [2]}),
    # group acc 1.0 -> th 0.75: 0.74 dropped, 0.76 kept
    "group_075_drop": ([0.5, 0.74, -1.0, 0.5], [8, 8, 0, 8], 0.1, {0: [3]}),
    "group_075_keep": ([0.5, 0.76, -1.0, 0.5], [8, 8, 0, 8], 0.1, {0: [3]}),
    "group_reported_by_best_member": ([0.4, -1.0, 0.9, -1.0], [8, 0, 0, 0],
                                      0.1, {0: [2]}),
    "no_common_word": ([0.4, 0.3], [0, 0], 0.0, {}),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_candidates_from_scores_equal(case):
    s, cw, min_score, nb = POLICY_CASES[case]
    g = _Graph(nb)
    args = (set(), min_score, g)
    ref = jv.KeyFrameDatabase.candidates_from_scores(
        None, np.asarray(s, np.float32), np.asarray(cw, np.int32), *args)
    out = tv.KeyFrameDatabase.candidates_from_scores(
        None, np.asarray(s, np.float32), np.asarray(cw, np.int32), *args)
    assert out == ref


def test_detect_candidates_on_a_covisibility_graph(trained):
    """Both retrieval entries, grouped and plain, equal on the same rows and
    a constructed covisibility graph, with an excluded keyframe."""
    _, jvoc = trained
    rng = np.random.default_rng(12)
    jdb, tdb, base = _filled(jvoc, rng)
    g = _Graph({0: [1, 2], 1: [0, 4], 2: [0], 4: [1, 5], 5: [4, 6],
                6: [5, 7], 7: [6, 8], 8: [7]})
    q = base.copy()
    q[rng.random(300) < 0.4] = rand_desc(rng, 1)[0]
    valid = np.ones(300, bool)
    jq, _ = jdb.compute_bow(jnp.asarray(q), jnp.asarray(valid))
    tq, _ = tdb.compute_bow(t_desc(q), torch.from_numpy(valid))
    for exclude in (set(), {0}):
        for ms in (0.0, 0.05):
            ref = jdb.detect_candidates_grouped(jq, set(exclude), ms, g, 5)
            out = tdb.detect_candidates_grouped(tq, set(exclude), ms, g, 5)
            assert out == ref and out
        ref = jdb.detect_candidates(jq, set(exclude), 0.015, 3)
        out = tdb.detect_candidates(tq, set(exclude), 0.015, 3)
        assert out == ref and out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dbow2_text_loads_equal_in_the_other_package(writer, trained,
                                                     tmp_path):
    _, jvoc = trained
    idf = np.random.default_rng(13).random(jvoc.n_words).astype(np.float32)
    jvoc = jv.Vocabulary(words=jvoc.words, idf=jnp.asarray(idf))
    p = str(tmp_path / "voc.txt")
    if writer == "jax":
        jv.save_dbow2_text(jvoc, p)
        out = tv.load_dbow2_text(p, device="cpu")
        ref = jv.load_dbow2_text(p)
    else:
        tv.save_dbow2_text(port_voc(jvoc), p)
        ref = jv.load_dbow2_text(p)
        out = tv.load_dbow2_text(p, device="cpu")
    np.testing.assert_array_equal(convert.vocabulary_to_numpy(out)["words"],
                                  np.asarray(ref.words))
    np.testing.assert_array_equal(out.idf.numpy(), np.asarray(ref.idf))
    np.testing.assert_array_equal(np.asarray(ref.words),
                                  np.asarray(jvoc.words))


def test_dbow2_tree_file_equal(trained, tmp_path):
    _, jvoc = trained
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jv.save_dbow2_tree(jvoc, a)
    tv.save_dbow2_tree(port_voc(jvoc), b)
    assert open(a).read() == open(b).read()


def test_transform_and_l1_similarity(trained):
    _, jvoc = trained
    idf = np.random.default_rng(14).random(jvoc.n_words).astype(np.float32)
    jvoc = jv.Vocabulary(words=jvoc.words, idf=jnp.asarray(idf))
    rng = np.random.default_rng(15)
    a, b = clustered_desc(rng, 200), clustered_desc(rng, 200)
    valid = rng.random(200) < 0.9
    out, ref = [], []
    for d in (a, b):
        v, w = tv.transform(port_voc(jvoc), t_desc(d), torch.from_numpy(valid))
        jv_, jw = jv.transform(jvoc, jnp.asarray(d), jnp.asarray(valid))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv_), rtol=0,
                                   atol=1e-6)
        out.append(v)
        ref.append(jv_)
    assert abs(float(tv.l1_similarity(*out))
               - float(jv.l1_similarity(*ref))) <= 1e-6
