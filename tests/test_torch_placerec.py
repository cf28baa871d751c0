"""The port's place recognizer (scavislam_tpu_torch.models.placerec) against
the JAX package's on the same rendered frames, on the CPU at 256x192.

RANSAC hypotheses are the one thing the frameworks cannot share: the port's
recognizer gets the twin's draws through its ``hypotheses`` seam, replayed
from the twin's key chain (PRNGKey(42), one split per geometric check, then
split -> k1 and randint(k1, (256, 3), 0, n) inside ransac_se3). The index
comparisons run from one shared index, carried over with
``interop.place_recognizer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence as JSeq
from scavislam_tpu.io.synthetic import closed_box as j_closed_box
from scavislam_tpu.models import placerec as jpr
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models import placerec as tpr

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
N_SPIN = 42  # two laps: frames 0..20 are the first 360-degree lap


class JaxDraws:
    """The twin recognizer's hypothesis draws, replayed from its key."""

    def __init__(self, key):
        self.key = key

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        k1, _ = jax.random.split(sub)
        return torch.as_tensor(np.array(
            jax.random.randint(k1, (tpr.NUM_HYPOTHESES, 3), 0, n)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab():
    return tpr.default_vocabulary()


@pytest.fixture(scope="module")
def spin():
    seq = JSeq(J_CAM, n_frames=N_SPIN, kind="spin", planes=j_closed_box(),
               step=2.0 / (N_SPIN - 1))
    out = []
    for i in range(N_SPIN):
        f = seq.frame(i)
        out.append({"img": np.array(f["left"]), "disp": np.array(f["disp_gt"]),
                    "T": (np.asarray(f["T_cw_gt"].R, np.float64),
                          np.asarray(f["T_cw_gt"].t, np.float64))})
    return out


def _index(pr, spin, to_input):
    """tests/test_placerec.py::test_revisit_detected's sequence: the first
    lap indexed with its 4 predecessors excluded, then second-lap frame 22
    as query 99. Returns the query's loop."""
    for kf_id in range(21):
        pr.add_location({"kf_id": kf_id, "img": to_input(spin[kf_id]["img"]),
                         "disp": to_input(spin[kf_id]["disp"]),
                         "exclude": set(range(max(0, kf_id - 4), kf_id + 1))})
    return pr.add_location({"kf_id": 99, "img": to_input(spin[22]["img"]),
                            "disp": to_input(spin[22]["disp"]),
                            "exclude": {99}})


@pytest.fixture(scope="module")
def revisit(spin, vocab):
    jp = jpr.PlaceRecognizer(J_CAM, vocab)
    j_loop = _index(jp, spin, jnp.asarray)
    tp = tpr.PlaceRecognizer(CAM, vocab, device="cpu")
    tp.hypotheses = JaxDraws(jax.random.PRNGKey(42))
    t_loop = _index(tp, spin, torch.as_tensor)
    return jp, j_loop, tp, t_loop


def _shared(jp, vocab, **kw):
    """A port recognizer on the twin's index, drawing the twin's next
    hypotheses."""
    tp = interop.place_recognizer(CAM, vocab, jp.location_map,
                                  jp.inverted_index, jp.word_doc_count,
                                  device="cpu", **kw)
    tp.hypotheses = JaxDraws(jp._key)
    return tp


def test_revisit_detected_matches_jax(revisit, spin):
    # the same loop_id, T_query_from_loop within 1e-4, and both within the
    # twin test's 0.02 of the ground-truth relative pose
    jp, j_loop, tp, t_loop = revisit
    assert j_loop is not None and t_loop is not None
    assert t_loop.loop_id == j_loop.loop_id in (1, 2)
    assert t_loop.query_id == j_loop.query_id == 99
    np.testing.assert_allclose(t_loop.T_query_from_loop.R,
                               np.asarray(j_loop.T_query_from_loop.R),
                               atol=1e-4)
    np.testing.assert_allclose(t_loop.T_query_from_loop.t,
                               np.asarray(j_loop.T_query_from_loop.t),
                               atol=1e-4)
    assert tp.counters["indexed"] == jp.counters["indexed"] == 22
    assert tp.counters["loops_emitted"] == jp.counters["loops_emitted"] >= 1
    assert tp.last_best[0] == jp.last_best[0]
    np.testing.assert_allclose(tp.last_best[1], jp.last_best[1], rtol=1e-4)
    Rq, tq = spin[22]["T"]
    Rl, tl = spin[t_loop.loop_id]["T"]
    R_gt = Rq @ Rl.T
    t_gt = tq - R_gt @ tl
    T = t_loop.T_query_from_loop
    assert np.abs(T.R - R_gt).max() < 0.02
    assert np.abs(T.t - t_gt).max() < 0.02


@pytest.mark.parametrize("idf_mode", ["reference", "log"])
def test_score_matches_jax_on_shared_index(revisit, vocab, idf_mode):
    # scores within 1e-5 relative, the same candidates, for the queries of
    # every indexed place with and without its exclusions
    jp = revisit[0]
    tp = _shared(jp, vocab, idf_mode=idf_mode)
    jp.idf_mode = idf_mode
    try:
        for kf, place in jp.location_map.items():
            for exclude in (place.exclude, set()):
                sj = jp._score(place.words, exclude)
                st = tp._score(np.array(place.words), exclude)
                assert sorted(st) == sorted(sj)
                for k in sj:
                    np.testing.assert_allclose(st[k], sj[k], rtol=1e-5)
    finally:
        jp.idf_mode = "reference"


def test_geometric_check_and_relocalize_match_jax(revisit, vocab, spin):
    # from one shared index and the same draws: the geometric check's
    # outcome and T within 1e-4, then relocalize's loop keyframe and
    # (R, t) within 1e-4
    jp = revisit[0]
    tp = _shared(jp, vocab)
    q, c = jp.location_map[99], jp.location_map[revisit[1].loop_id]
    lj = jp._geometric_check(q, c)
    lt = tp._geometric_check(tp.location_map[99],
                             tp.location_map[revisit[1].loop_id])
    assert lj is not None and lt is not None
    np.testing.assert_allclose(lt.T_query_from_loop.R,
                               np.asarray(lj.T_query_from_loop.R), atol=1e-4)
    np.testing.assert_allclose(lt.T_query_from_loop.t,
                               np.asarray(lj.T_query_from_loop.t), atol=1e-4)
    # a place too far from the query (half a lap) fails on both sides
    far = jp.location_map[11]
    assert jp._geometric_check(q, far) is None
    assert tp._geometric_check(tp.location_map[99],
                               tp.location_map[11]) is None
    for i in (5, 30):
        f = spin[i]
        hj = jp.relocalize(jnp.asarray(f["img"]), jnp.asarray(f["disp"]))
        ht = tp.relocalize(torch.as_tensor(f["img"]),
                           torch.as_tensor(f["disp"]))
        assert hj is not None and ht is not None
        assert ht[0] == hj[0]
        np.testing.assert_allclose(ht[1][0], hj[1][0], atol=1e-4)
        np.testing.assert_allclose(ht[1][1], hj[1][1], atol=1e-4)


def test_no_loop_for_excluded_neighbors():
    seq = SyntheticSequence(CAM, n_frames=2, step=0.02, device="cpu")
    pr = tpr.PlaceRecognizer(CAM, device="cpu")
    f0 = seq.frame(0)
    assert pr.add_location({"kf_id": 0, "img": f0["left"],
                            "disp": f0["disp_gt"], "exclude": {0}}) is None
    f1 = seq.frame(1)
    loop = pr.add_location({
        "kf_id": 1, "img": f1["left"], "disp": f1["disp_gt"],
        # kf0 is covisible -> excluded -> no loop
        "exclude": {0, 1},
    })
    assert loop is None
    assert pr.counters["indexed"] == pr.counters["described"] == 2


def test_unpack_bow_layout():
    # [word | desc(128) | u v d | x y z | valid] per row
    packed = np.arange(4 * 136, dtype=np.float32).reshape(4, 136)
    packed[:, 135] = [1.0, 0.0, 0.7, 0.2]
    words, desc, uvd, xyz, valid = tpr.unpack_bow(packed)
    assert words.dtype == np.int64
    np.testing.assert_array_equal(words, packed[:, 0])
    np.testing.assert_array_equal(desc, packed[:, 1:129])
    np.testing.assert_array_equal(uvd, packed[:, 129:132])
    np.testing.assert_array_equal(xyz, packed[:, 132:135])
    np.testing.assert_array_equal(valid, [True, False, True, False])
    for a, b in zip(tpr.unpack_bow(packed), jpr.unpack_bow(packed)):
        np.testing.assert_array_equal(a, b)


def test_train_vocabulary_matches_jax_from_same_centres():
    # the twin's initial centres (jax.random.choice) handed to the port:
    # the trained centres within 1e-5
    rng = np.random.RandomState(3)
    data = rng.randn(3000, 128).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    k, seed = 32, 5
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), len(data),
                                        (k,), replace=False))
    vj = jpr.train_vocabulary(data, k=k, iters=5, seed=seed, chunk=1024)
    vt = tpr.train_vocabulary(data, k=k, iters=5, chunk=1024,
                              init_centers=data[init], device="cpu")
    np.testing.assert_allclose(vt, vj, atol=1e-5)


def test_kmeans_clusters_separate_data():
    # mirror of tests/test_placerec.py::TestKMeans
    rng = np.random.RandomState(0)
    a = rng.randn(200, 128) * 0.05 + np.eye(128)[0]
    b = rng.randn(200, 128) * 0.05 + np.eye(128)[64]
    data = np.concatenate([a, b]).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    vocab = tpr.train_vocabulary(data, k=2, iters=10, device="cpu")
    assign = (data @ vocab.T).argmax(1)
    assert assign[:200].std() < 0.2 and assign[200:].std() < 0.2
    assert assign[0] != assign[200]


def test_default_vocabulary_shape():
    v = tpr.default_vocabulary()
    assert v.shape == (10000, 128) and v.dtype == np.float32
    assert interop.vocabulary(v, "cpu").shape == (10000, 128)
