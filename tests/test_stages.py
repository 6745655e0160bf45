"""The extractor's FAST score+NMS and the fuse matcher against the plain
numpy references in ops/numpy_reference.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weiner_slamit_v2_tpu.frontend import matcher
from weiner_slamit_v2_tpu.ops import fast, numpy_reference


def blob_image(h=160, w=256, seed=3):
    """Corner-rich image: bright axis-aligned squares on a dark background
    (every square corner is a FAST-9 corner, unlike a checkerboard whose
    saddle corners have no 9-contiguous arc)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 20.0, np.float32)
    for _ in range(40):
        y = rng.integers(8, h - 24)
        x = rng.integers(8, w - 24)
        s = rng.integers(6, 16)
        img[y : y + s, x : x + s] = 220.0
    return img


def texture(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def checkerboard(h=128, w=256):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy // 12) + (xx // 12)) % 2).astype(np.float32) * 200.0


class TestFastScoreNms:
    @pytest.mark.parametrize(
        "name, img, min_corners",
        [
            ("texture", texture(192, 256, 0), 20),
            ("blobs", blob_image(), 20),
            # a perfect checkerboard has NO FAST-9 corners (a saddle's ring
            # alternates every quarter turn: longest arc 8 < 9)
            ("checkerboard", checkerboard(), 0),
            ("height_not_multiple_of_64", texture(150, 256, 1), 20),
        ],
    )
    def test_matches_numpy(self, name, img, min_corners):
        for th in (0.0, 7.0):
            got = np.asarray(fast.fast_score_nms(jnp.asarray(img), th))
            ref = numpy_reference.fast9_nms(img, th)
            np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=name)
        assert (ref > 0).sum() >= min_corners
        if min_corners == 0:
            assert (ref > 0).sum() == 0


def fuse_inputs(seed=0, N1=200, N2=300, d1=None):
    rng = np.random.default_rng(seed)
    if d1 is None:
        d1 = rng.integers(0, 2**32, (N1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (N2, 8), dtype=np.uint32)
    # plant near-duplicates so best distances are small and mostly unique
    d2[:N1 // 2] = d1[:N1 // 2] ^ (
        rng.integers(0, 2**32, (N1 // 2, 8), dtype=np.uint32)
        & rng.integers(0, 2**32, (N1 // 2, 8), dtype=np.uint32)
        & rng.integers(0, 2**32, (N1 // 2, 8), dtype=np.uint32)
    )
    return dict(
        desc1=d1, desc2=d2,
        valid1=rng.random(N1) > 0.1, valid2=rng.random(N2) > 0.1,
        pred_xy=rng.uniform(0, 320, (N1, 2)).astype(np.float32),
        xy2=rng.uniform(0, 320, (N2, 2)).astype(np.float32),
        window=rng.uniform(20, 120, N1).astype(np.float32),
        oct_lo=rng.integers(0, 3, N1).astype(np.int32),
        oct_hi=rng.integers(3, 5, N1).astype(np.int32),
        octave2=rng.integers(0, 6, N2).astype(np.int32),
        chi2_w=rng.uniform(0.3, 1.0, N2).astype(np.float32),
    )


def assert_same_as_numpy(got, d, chi2_th):
    bi, bd, sd = (np.asarray(a) for a in got)
    ri, rb, rs = numpy_reference.windowed_best2(**d, chi2_th=chi2_th)
    np.testing.assert_array_equal(bd, rb)
    np.testing.assert_array_equal(sd, rs)
    unique = (rb < numpy_reference.INVALID_DIST) & (rb < rs)
    np.testing.assert_array_equal(bi[unique], ri[unique])
    assert unique.sum() > 20


class TestFuseMatcher:
    def test_plain(self):
        """Zero chi2 weights: window, level and validity gates only."""
        d = dict(fuse_inputs(), chi2_w=np.zeros(300, np.float32))
        j = {k: jnp.asarray(v) for k, v in d.items()}
        assert_same_as_numpy(matcher.windowed_best2(**j, chi2_th=0.0), d, 0.0)

    def test_chi2_gate(self):
        d = fuse_inputs(seed=5)
        j = {k: jnp.asarray(v) for k, v in d.items()}
        got = matcher.windowed_best2(**j, chi2_th=800.0)
        assert_same_as_numpy(got, d, 800.0)
        # the gate removes candidates the ungated search keeps
        plain = matcher.windowed_best2(
            **dict(j, chi2_w=jnp.zeros(300)), chi2_th=0.0
        )
        assert int((got[1] > plain[1]).sum()) > 0

    def test_vmap_over_targets(self):
        """The fuse pass's batched form: one program over several target
        keyframes (shared point descriptors, per-target features)."""
        ds = [fuse_inputs(seed=9)]
        ds += [fuse_inputs(seed=s, d1=ds[0]["desc1"]) for s in (10, 11)]
        d1 = jnp.asarray(ds[0]["desc1"])
        keys = [k for k in ds[0] if k != "desc1"]
        stacked = [jnp.stack([jnp.asarray(d[k]) for d in ds]) for k in keys]

        def one(*xs):
            return matcher.windowed_best2(d1, *xs, chi2_th=800.0)

        bi, bd, sd = jax.jit(jax.vmap(one))(*stacked)
        for b, d in enumerate(ds):
            assert_same_as_numpy((bi[b], bd[b], sd[b]), d, 800.0)


class TestFastTritonInterpret:
    """The GPU kernels of ops/fast_triton.py, run in interpret mode, against
    the XLA form (which the numpy reference above pins down)."""

    @pytest.mark.parametrize(
        "name, img",
        [
            ("texture", texture(40, 70, 2)),
            ("blobs", blob_image(64, 96, 4)),
            ("tile_edges", texture(33, 129, 3)),  # one row/col past a tile
        ],
    )
    def test_matches_xla(self, name, img):
        from weiner_slamit_v2_tpu.ops.fast_triton import fast_score_nms_triton

        got = fast_score_nms_triton(jnp.asarray(img), 7.0, interpret=True)
        ref = fast.fast_score_nms(jnp.asarray(img), 7.0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert int((np.asarray(ref) > 0).sum()) > 5

    def test_extractor_picks_the_xla_form_off_gpu(self):
        """On the CPU the extractor's detector lowers its default branch:
        the compiled program holds no Triton call."""
        from weiner_slamit_v2_tpu.frontend.extractor import detect_level

        img = jnp.asarray(texture(48, 64, 5))
        hlo = jax.jit(detect_level, static_argnums=1).lower(img, 7.0).as_text()
        assert "triton" not in hlo.lower()
        np.testing.assert_array_equal(
            np.asarray(detect_level(img, 7.0)),
            np.asarray(fast.fast_score_nms(img, 7.0)),
        )

    def test_batched_under_vmap(self):
        """Data-parallel extraction vmaps the detector over frames."""
        from weiner_slamit_v2_tpu.ops.fast_triton import fast_score_nms_triton

        imgs = jnp.stack([jnp.asarray(texture(40, 70, s)) for s in (6, 7)])
        got = jax.vmap(
            lambda x: fast_score_nms_triton(x, 7.0, interpret=True)
        )(imgs)
        ref = jax.vmap(lambda x: fast.fast_score_nms(x, 7.0))(imgs)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
