"""Appearance-based place recognition: bag-of-words + geometric verification
(port of scavislam_tpu.models.placerec).

Per keyframe: keypoints that carry disparity are described and quantized to
visual words (ops.descriptors.bow_describe), candidate locations are scored
by TF-IDF over an inverted index that excludes the covisible neighborhood
(placerecognizer.cpp:130-172, 249-298), and the best candidate (score > 2.0)
is confirmed by a 3-point RANSAC absolute orientation (> 30 inliers ->
DetectedLoop, placerecognizer.cpp:174-202).

Device work: the describe (one ``bow_describe`` and one download; skipped
when the keyframe packet carries the ``pr_packed`` block its spawn step
computed) and the geometric check (match + RANSAC + refine at the fixed
capacity MAX_KEYPOINTS: one packed upload, one packed download, on the
recognizer's own CUDA stream). The inverted index and TF-IDF bookkeeping
stay on the host.

Random numbers: the RANSAC hypotheses come from ``hypotheses(n)``, which
draws from the recognizer's ``torch.Generator`` (seeded 42, as the twin's
``PRNGKey(42)``): one draw per geometric check and one in ``warmup``, where
the twin splits its key. A caller that wants the twin's exact hypotheses
replaces ``hypotheses`` on the instance.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import Counter, defaultdict
from contextlib import nullcontext

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.models.backend import DetectedLoop
from scavislam_tpu_torch.models.frontend import Fetch, _upload_f32
from scavislam_tpu_torch.ops.descriptors import (BOW_KEYPOINTS, DESC_DIM,
                                                 bow_describe,
                                                 match_descriptors)
from scavislam_tpu_torch.ops.ransac import (draw_hypotheses,
                                            ransac_se3,
                                            refine_se3_from_inliers)
from scavislam_tpu_torch.pipeline.monitors import PlaceRecognizerMonitor

SCORE_THR = 2.0  # placerecognizer.cpp best-score acceptance
MIN_INLIERS = 30  # placerecognizer.cpp:197 (>30 inliers)
MAX_KEYPOINTS = BOW_KEYPOINTS
NUM_HYPOTHESES = 256
INLIER_THR = 3.0
# the PR thread's sleep after a poll that found no work (the twin's 1 ms)
POLL_IDLE_S = 0.001
# the shipped trained dictionary, read by path as a data file
VOCABULARY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "scavislam_tpu", "data", "vocabulary.npz")


class Place:
    """Stored location (parity: Place, placerecognizer.h)."""

    def __init__(self, kf_id, words, desc, uvd, xyz, exclude,
                 padded=None):
        self.kf_id = kf_id
        self.words = words  # (N,) word ids
        self.desc = desc  # (N, 128)
        self.uvd = uvd  # (N, 3) u, v, disparity
        self.xyz = xyz  # (N, 3) camera-frame points
        self.exclude = exclude  # covisible kf ids at insertion time
        self.n_words = len(words)  # parity: Location::number_of_words
        # fixed-capacity (MAX_KEYPOINTS) padded views for the device-side
        # geometric check: (desc_p, xyz_p, valid_p) or None
        self.padded = padded


def random_vocabulary(k=1024, dim=128, seed=0) -> np.ndarray:
    """Random unit vocabulary: last-resort fallback and test fixture only
    (random projections give no TF-IDF separation at the reference
    operating point; production paths use the trained dictionary)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(k, dim).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    return v


def default_vocabulary() -> np.ndarray:
    """The shipped trained dictionary (``scavislam_tpu/data/vocabulary.npz``,
    key ``vocab``, (10000, 128) f32: the reference's vocabulary scale, the
    counterpart of its data/surfwords10000.png, placerecognizer.cpp:87-112),
    read with numpy. Falls back to a random vocabulary with a loud warning
    if the file is missing: recall is badly degraded then."""
    if os.path.exists(VOCABULARY_PATH):
        return np.load(VOCABULARY_PATH)["vocab"].astype(np.float32)
    warnings.warn(
        "scavislam_tpu/data/vocabulary.npz not found — falling back to a "
        "RANDOM vocabulary; loop-closure/relocalization recall will be "
        "severely degraded. Train one with apps/create_dictionary.",
        stacklevel=2)
    return random_vocabulary()


def unpack_bow(packed: np.ndarray):
    """Split one bow_describe block [word | desc | u v d | x y z | valid]
    into (words int64, desc, uvd, xyz, valid bool) numpy views."""
    dcols = packed.shape[1] - 8
    return (
        packed[:, 0].astype(np.int64),
        packed[:, 1:1 + dcols],
        packed[:, 1 + dcols:4 + dcols],
        packed[:, 4 + dcols:7 + dcols],
        packed[:, 7 + dcols] > 0.5,
    )


def _geom_check_device(idx, desc_a, xyz_qa, valid_a, desc_b, xyz_cb, valid_b,
                       cam_params, inlier_thr):
    """The geometric-check program: BF match + 3-point RANSAC on the
    hypotheses `idx` + inlier refit, returning ONE packed vector
    [R(9), t(3), n_matched, n_inliers] (T_query_from_loop)."""
    idx_b, ok = match_descriptors(desc_a, desc_b,
                                  valid_a=valid_a, valid_b=valid_b)
    # correspondences: loop (candidate) points -> query points
    xyz_a = torch.where(ok[:, None], xyz_cb[idx_b], 0.0)
    R, t, inliers, n_in = ransac_se3(idx, xyz_a, xyz_qa, ok, cam_params,
                                     inlier_thr=inlier_thr)
    T = refine_se3_from_inliers(xyz_a, xyz_qa, inliers)
    return torch.cat([
        T.R.reshape(9), T.t,
        torch.sum(ok).to(torch.float32)[None],
        n_in.to(torch.float32)[None],
    ])


class PlaceRecognizer:
    def __init__(self, cam: StereoCamera, vocabulary=None,
                 monitor: PlaceRecognizerMonitor = None,
                 score_thr: float = SCORE_THR,
                 min_inliers: int = MIN_INLIERS,
                 idf_mode: str = "reference", device=None):
        # idf_mode: "reference" is the reference's unlogged idf =
        # n_docs / postings (placerecognizer.cpp:161-171), for which the
        # threshold 2.0 carries over; "log" (log1p of it) is the twin's
        # experiment flag, whose thresholds do not carry over
        assert idf_mode in ("reference", "log")
        self.idf_mode = idf_mode
        self.cam = cam
        self.device = resolve_device(device)
        if vocabulary is None:
            vocabulary = default_vocabulary()
        self.vocab = torch.as_tensor(
            vocabulary if isinstance(vocabulary, torch.Tensor)
            else np.asarray(vocabulary, np.float32),
            dtype=torch.float32, device=self.device)
        self.monitor = monitor or PlaceRecognizerMonitor()
        self.score_thr = score_thr
        self.min_inliers = min_inliers
        self.location_map: dict[int, Place] = {}
        self.inverted_index: dict[int, dict[int, int]] = defaultdict(dict)
        self.word_doc_count: dict[int, int] = defaultdict(int)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(42)
        # the geometric check's own stream (None on the CPU)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._cam_params = (float(cam.focal), float(cam.pp[0]),
                            float(cam.pp[1]), float(cam.baseline))
        self.counters = Counter()  # indexed / over_thr / geo checks / loops
        self.last_best = None
        self.working = False

    def hypotheses(self, n: int) -> torch.Tensor:
        """The RANSAC draw of one geometric check: (NUM_HYPOTHESES, 3) raw
        indices in [0, n) from the recognizer's generator, on its device."""
        return draw_hypotheses(n, NUM_HYPOTHESES, self.generator, self.device)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    # ------------------------------------------------------------------ #
    def describe(self, img, disp):
        """Detect + describe keypoints that carry disparity (parity:
        placerecognizer.cpp:222-246): one ``bow_describe`` and one packed
        download, on the caller's current stream (counted in
        ``counters["described"]``). ``disp=None`` selects the monocular
        branch (no depth gate, zero xyz)."""
        self.counters["described"] += 1
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        mono = disp is None
        disp = (torch.zeros_like(img) if mono else
                torch.as_tensor(disp, dtype=torch.float32, device=self.device))
        packed = Fetch(bow_describe(img, disp, self.vocab, self._cam_params,
                                    mono)).result()
        return unpack_bow(packed)

    # ------------------------------------------------------------------ #
    def step(self) -> bool:
        """One poll of the PR thread loop (placerecognizer.cpp:114-128)."""
        data = self.monitor.getKeyframeDate()
        if data is None:
            return False
        self.add_location(data)
        return True

    def run(self, stop_event):
        """Thread entry point: poll, sleeping POLL_IDLE_S after an idle
        poll, as the twin does."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else nullcontext())
        with ctx:
            self.working = False
            while not stop_event.is_set():
                self.working = True
                did = self.step()
                self.working = False
                if not did:
                    time.sleep(POLL_IDLE_S)

    def warmup(self):
        """Run every device program of the PR path once (describe + match +
        RANSAC + refine at the padded capacity): the first call of each
        pays the library's one-time set-up (cuBLAS handles, allocator
        growth) outside a timed run. Consumes one hypothesis draw, as the
        twin's warmup splits its key once."""
        h, w = self.cam.size[1], self.cam.size[0]
        img = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        self.describe(img, torch.full_like(img, 5.0))
        n = MAX_KEYPOINTS
        z = np.zeros((n, DESC_DIM), np.float32)
        self._check_dispatch(
            z, np.zeros((n, 3), np.float32), np.ones(n, bool),
            z, np.zeros((n, 3), np.float32), np.ones(n, bool)).result()

    def add_location(self, data: dict):
        """Parity: addLocation (placerecognizer.cpp:206-324). A packet with a
        ``pr_packed`` block (computed in the keyframe's spawn step) costs no
        device work here: only host bookkeeping and the rare geometric
        check."""
        kf_id = data["kf_id"]
        if data.get("pr_packed") is not None:
            words, desc, uvd, xyz, valid = unpack_bow(
                np.asarray(data["pr_packed"]))
        else:
            words, desc, uvd, xyz, valid = self.describe(
                data["img"], data["disp"])
        padded = (np.asarray(desc, np.float32), np.asarray(xyz, np.float32),
                  np.asarray(valid, bool))
        words = words[valid]
        desc = desc[valid]
        uvd = uvd[valid]
        xyz = xyz[valid]
        exclude = set(data.get("exclude", set())) | {kf_id}

        # TF-IDF scoring against existing locations (calcLoopStatistics)
        scores = self._score(words, exclude)
        place = Place(kf_id, words, desc, uvd, xyz, exclude, padded=padded)
        self.location_map[kf_id] = place
        for w, c in zip(*np.unique(words, return_counts=True)):
            self.inverted_index[int(w)][kf_id] = int(c)
            self.word_doc_count[int(w)] += 1

        self.counters["indexed"] += 1
        self.last_best = None  # (kf_id, score) of this query's best match
        if not scores:
            return None
        best_id, best_score = max(scores.items(), key=lambda kv: kv[1])
        self.last_best = (best_id, float(best_score))
        self.counters["best_score_max"] = max(
            self.counters["best_score_max"], int(best_score * 100))
        if best_score <= self.score_thr:
            return None
        self.counters["over_threshold"] += 1
        loop = self._geometric_check(place, self.location_map[best_id])
        if loop is not None:
            self.counters["loops_emitted"] += 1
            self.monitor.addLoop(loop)
        return loop

    def _score(self, words: np.ndarray, exclude: set) -> dict:
        """TF-IDF accumulation over the inverted index, excluding the covis
        neighborhood: the reference formula (placerecognizer.cpp:131-171,
        per query descriptor at 254-298)

            score[other] = sum_w  c_query(w) * tf(w, other) * idf(w)
            tf  = wordcount(w, other) / number_of_words(other)
            idf = n_locations / n_locations_containing_word   (unlogged)

        with n_locations the index size before the query is inserted."""
        n_docs = float(max(len(self.location_map), 1))
        scores: dict[int, float] = defaultdict(float)
        uw, counts = np.unique(words, return_counts=True)
        log_mode = self.idf_mode == "log"
        for w, c in zip(uw, counts):
            postings = self.inverted_index.get(int(w))
            if not postings:
                continue
            idf = n_docs / len(postings)
            if log_mode:
                idf = float(np.log1p(idf))
            for kf, kc in postings.items():
                if kf in exclude:
                    continue
                n_other = max(self.location_map[kf].n_words, 1)
                scores[kf] += float(c) * (float(kc) / n_other) * idf
        return dict(scores)

    def _check_dispatch(self, desc_a, xyz_qa, valid_a, desc_b, xyz_cb,
                        valid_b) -> Fetch:
        """Enqueue one geometric-check program on the recognizer's stream:
        the six host arrays go up as one pinned f32 upload, the packed
        result [R(9), t(3), n_matched, n_inliers] comes down as one
        :class:`Fetch`; nothing here waits on the device."""
        na, nb = len(desc_a), len(desc_b)
        buf = np.concatenate([
            np.asarray(desc_a, np.float32).ravel(),
            np.asarray(xyz_qa, np.float32).ravel(),
            np.asarray(valid_a, np.float32),
            np.asarray(desc_b, np.float32).ravel(),
            np.asarray(xyz_cb, np.float32).ravel(),
            np.asarray(valid_b, np.float32),
        ])
        d = DESC_DIM
        with self._on_stream():
            dev = _upload_f32(buf, self.device)
            o = 0
            parts = []
            for n in (na, nb):
                parts.append(dev[o:o + n * d].reshape(n, d))
                o += n * d
                parts.append(dev[o:o + n * 3].reshape(n, 3))
                o += n * 3
                parts.append(dev[o:o + n] > 0.5)
                o += n
            idx = self.hypotheses(na)
            return Fetch(_geom_check_device(idx, *parts, self._cam_params,
                                            INLIER_THR))

    def _geometric_check(self, query: Place, cand: Place):
        """BF match + 3-point RANSAC (placerecognizer.cpp:174-202) on the
        fixed-capacity padded views. Returns a DetectedLoop with
        T_query_from_loop (a host PoseRT) or None."""
        if len(query.words) < 3 or len(cand.words) < 3:
            return None
        if query.padded is not None and cand.padded is not None:
            desc_a, xyz_qa, valid_a = query.padded
            desc_b, xyz_cb, valid_b = cand.padded
        else:  # unpadded places (tests constructing Place directly)
            desc_a, xyz_qa = query.desc, query.xyz
            valid_a = np.ones(len(desc_a), bool)
            desc_b, xyz_cb = cand.desc, cand.xyz
            valid_b = np.ones(len(desc_b), bool)
        packed = self._check_dispatch(desc_a, xyz_qa, valid_a, desc_b,
                                      xyz_cb, valid_b).result()
        n_matched, n_in = int(packed[12]), int(packed[13])
        if n_matched < 3 or n_in <= self.min_inliers:
            return None
        T = PoseRT(packed[:9].reshape(3, 3).astype(np.float64),
                   packed[9:12].astype(np.float64))
        return DetectedLoop(query.kf_id, cand.kf_id, T)

    def relocalize(self, img, disp, top_k: int = 3):
        """Global relocalization: where is an arbitrary frame, with no
        covisibility prior. The same BoW index and geometric check as loop
        closure answer the kidnapped-robot query: TF-IDF scoring with an
        empty exclude set, then the geometric check against the top-k
        scoring keyframes. (The reference has no recovery: it exits on
        tracking failure, stereo_slam.cpp:706-710.)

        Returns (loop_kf_id, (R, t) of T_query_from_loop as f32 numpy) or
        None."""
        words, desc, uvd, xyz, valid = self.describe(img, disp)
        wv = words[valid]
        if len(wv) < 3 or not self.location_map:
            return None
        scores = self._score(wv, exclude=set())
        if not scores:
            return None
        best = sorted(scores.items(), key=lambda kv: -kv[1])[:top_k]
        place = Place(-1, wv, desc[valid], uvd[valid], xyz[valid], set(),
                      padded=(np.asarray(desc, np.float32),
                              np.asarray(xyz, np.float32),
                              np.asarray(valid, bool)))
        for kf, _sc in best:
            loop = self._geometric_check(place, self.location_map[kf])
            if loop is not None:
                T = loop.T_query_from_loop
                return loop.loop_id, (np.asarray(T.R, np.float32),
                                      np.asarray(T.t, np.float32))
        return None


# -- vocabulary training (device k-means) ----------------------------------- #

def train_vocabulary(descriptors: np.ndarray, k: int = 1024,
                     iters: int = 20, seed: int = 0, chunk: int = 16384,
                     init_centers: np.ndarray = None,
                     device=None) -> np.ndarray:
    """Batched Lloyd's k-means on the device (the reference uses FLANN
    hierarchical k-means offline, create_dictionary.cpp:144-177). Each
    iteration assigns `chunk`-row blocks by one (chunk, k) matmul + argmax
    and accumulates the centre sums and counts with ``index_add_``; empty
    clusters keep their centre; centres are re-normalized.

    The initial centres are `k` distinct descriptors drawn with a
    ``torch.Generator`` seeded `seed` (with replacement when there are
    fewer than `k`), or `init_centers` when given (the twin draws with
    ``jax.random.choice``, which no torch generator reproduces)."""
    dev = resolve_device(device)
    d = torch.as_tensor(np.asarray(descriptors, np.float32), device=dev)
    n, dim = d.shape
    if init_centers is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        pick = (torch.randint(0, n, (k,), generator=g, device=dev) if n < k
                else torch.randperm(n, generator=g, device=dev)[:k])
        centers = d[pick]
    else:
        centers = torch.as_tensor(np.asarray(init_centers, np.float32),
                                  device=dev)
    ones = torch.ones(min(chunk, n), dtype=torch.float32, device=dev)
    for _ in range(iters):
        sums = torch.zeros((k, dim), dtype=torch.float32, device=dev)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        for s in range(0, n, chunk):
            dc = d[s:s + chunk]
            assign = torch.argmax(dc @ centers.T, dim=1)
            sums.index_add_(0, assign, dc)
            counts.index_add_(0, assign, ones[:len(dc)])
        counts = counts[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centers)
        norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        centers = new / torch.clamp(norm, min=1e-9)
    return centers.cpu().numpy()
