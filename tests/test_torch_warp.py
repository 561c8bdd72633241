"""pose_tpu_torch warp: the split warp's host gate, its plain PyTorch
version (what the CUDA kernel computes) and the mxu warp, held against the
JAX package on the same numpy inputs.

The oracle of the split warp is the Pallas `_split_kernel` itself, run in
interpret mode (`warp_batch_split(..., interpret=True)`, as
tests/test_split_warp.py runs it), and JAX's matmul stage B
(`stage_b='mxu'`). Sizes are the CPU-test cut of the serving shape:
canvas <= 128, out 65, m 64, band 24 (split_defaults((65, 65))).

The kernel itself runs only on a card: tests/test_torch_cuda.py builds it
and holds it against the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_tpu.ops import warp as jwarp
from pose_tpu.ops import warp_pallas as jwarp_pallas
from pose_tpu.data import augment as jaugment

from pose_tpu_torch import cuda_build
from pose_tpu_torch.data import augment
from pose_tpu_torch.ops import warp, warp_cuda

S, OUT = 128, 65
M, BAND = warp.split_defaults((OUT, OUT))


def crop_hom(s, out, zoom=1.0, th=0.0, tx=0.0, ty=0.0, p=0.0):
    sc = (s * 0.7) / out / zoom
    c, sn = np.cos(th), np.sin(th)
    return np.array([[sc * c, -sc * sn, tx], [sc * sn, sc * c, ty],
                     [p, -p, 1.0]], np.float32)


def gate_homs(n=120, seed=0):
    """A distribution wider than the loader's, so the gate both accepts
    and rejects, plus degenerate homographies (w = 0 rows, a singular
    matrix, non-finite entries)."""
    rng = np.random.RandomState(seed)
    homs = [crop_hom(S, OUT, zoom=rng.uniform(0.6, 1.5),
                     th=rng.uniform(-0.35, 0.35),
                     tx=rng.uniform(-10, 30), ty=rng.uniform(-10, 30),
                     p=rng.uniform(-3e-3, 3e-3)) for _ in range(n)]
    bad = np.eye(3, dtype=np.float32)
    bad[2, 2] = 0.0
    singular = np.zeros((3, 3), np.float32)
    nan = crop_hom(S, OUT)
    nan[0, 1] = np.nan
    return np.stack(homs + [bad, singular, nan])


def batch(seed, u8=True, small_extents=False, b=2):
    rng = np.random.RandomState(seed)
    if u8:
        imgs = rng.randint(0, 256, (b, S, S, 3), dtype=np.uint8)
    else:
        imgs = rng.rand(b, S, S, 3).astype(np.float32)
    homs = np.stack([crop_hom(S, OUT, 1.0, 0.03, 5, 8, 1e-4),
                     crop_hom(S, OUT, 0.92, -0.05, 12, 3)][:b])
    ext = np.tile([S, S], (b, 1)).astype(np.int32)
    if small_extents:
        ext = ext - np.array([[28, 17], [40, 9]][:b], np.int32)
        for i, (h, w) in enumerate(ext):        # zero-padded canvases
            imgs[i, h:] = 0
            imgs[i, :, w:] = 0
    assert jwarp.split_band_ok(homs, (OUT, OUT))
    return imgs, homs, ext


def port_split(imgs, homs, ext, stage_b, wdtype=None):
    return warp.warp_batch_split(
        torch.as_tensor(imgs), torch.as_tensor(homs), (OUT, OUT),
        torch.as_tensor(ext), stage_b=stage_b, planar_out=True,
        wdtype=wdtype).numpy()


class TestGate:
    def test_split_band_ok_agrees_with_jax_per_homography(self):
        homs = gate_homs()
        ours = [warp.split_band_ok(h[None], (OUT, OUT)) for h in homs]
        ref = [jwarp.split_band_ok(h[None], (OUT, OUT)) for h in homs]
        assert ours == ref
        assert 20 <= sum(ours) <= len(homs) - 20     # exercised both ways
        assert not any(ours[-3:])                     # degenerate rejected

    @pytest.mark.parametrize('band', [16, 24, 32])
    def test_band_ok_v2_agrees_with_jax(self, band):
        homs = gate_homs(seed=band).astype(np.float64)
        for h in homs:
            r, _ = jwarp.decompose_homography(h, (OUT, OUT), M, xp=np)
            assert (warp_cuda.band_ok_v2(r[None], (M, M), (OUT, OUT), band)
                    == jwarp_pallas.band_ok_v2(r[None], (M, M), (OUT, OUT),
                                               band))

    def test_batch_gate_is_all_rows(self):
        homs = gate_homs()
        ok = [jwarp.split_band_ok(h[None], (OUT, OUT)) for h in homs]
        good = homs[np.flatnonzero(ok)[:4]]
        bad = homs[np.flatnonzero(np.logical_not(ok))[:1]]
        assert warp.split_band_ok(good, (OUT, OUT))
        assert not warp.split_band_ok(np.concatenate([good, bad]),
                                      (OUT, OUT))


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_decompose_homography_matches(dtype):
    """numpy f64 is the host gate's precision, f32 the device's; the JAX
    f32 path uses Precision.HIGHEST einsums, so both agree to roundoff."""
    homs = gate_homs()[:-3].astype(dtype)
    r_j, s_j = jwarp.decompose_homography(homs, (OUT, OUT), M, xp=np)
    r_t, s_t = warp.decompose_homography(torch.as_tensor(homs), (OUT, OUT),
                                         M)
    tol = 1e-12 if dtype == 'float64' else 1e-5
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=tol, atol=tol)


class TestSplitPlain:
    @pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float32'])
    @pytest.mark.parametrize('small_extents', [False, True],
                             ids=['full', 'extents'])
    def test_matches_pallas_split_kernel_interpret(self, u8, small_extents):
        """f32 weights: the plain version against the Pallas _split_kernel
        (interpret mode). The two sum the same 2-tap products in another
        order; measured <= 1e-5 on values in [0, 1], bound 1e-4 (the bound
        tests/test_split_warp.py holds the kernel to against the matmul
        path)."""
        imgs, homs, ext = batch(10 + 2 * u8 + small_extents, u8,
                                small_extents)
        ref = np.asarray(jwarp.warp_batch_split(
            jnp.asarray(imgs), jnp.asarray(homs), (OUT, OUT),
            jnp.asarray(ext), interpret=True, planar_out=True))
        ours = port_split(imgs, homs, ext, 'mxu', torch.float32)
        assert ours.shape == (2, 3, OUT, OUT)
        np.testing.assert_allclose(ours, ref, atol=1e-4)

    def test_bf16_weights_match_pallas_interpret(self):
        """bf16 wdtype: hat weights and the stage-A row result rounded to
        bf16 on both sides; uint8 sources are exact in bf16. Same 1e-4
        bound (measured <= 4e-6)."""
        imgs, homs, ext = batch(20, True, True)
        ref = np.asarray(jwarp.warp_batch_split(
            jnp.asarray(imgs), jnp.asarray(homs), (OUT, OUT),
            jnp.asarray(ext), interpret=True, planar_out=True,
            wdtype=jnp.bfloat16))
        ours = port_split(imgs, homs, ext, 'mxu', torch.bfloat16)
        np.testing.assert_allclose(ours, ref, atol=1e-4)
        # and the bf16 rounding is really applied: f32 weights differ
        f32 = port_split(imgs, homs, ext, 'mxu', torch.float32)
        assert np.abs(f32 - ours).max() > 1e-4

    @pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float32'])
    def test_matches_jax_stage_b_mxu(self, u8):
        """Against JAX's matmul stage B on the CPU (f32 there): the same
        dense dots, bound 1e-5 (f32 roundoff of 2-term sums)."""
        imgs, homs, ext = batch(30 + u8, u8, True)
        ref = np.asarray(jwarp.warp_batch_split(
            jnp.asarray(imgs), jnp.asarray(homs), (OUT, OUT),
            jnp.asarray(ext), stage_b='mxu', planar_out=True))
        ours = port_split(imgs, homs, ext, 'mxu')
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_cuda_stage_on_cpu_tensors_is_the_plain_version(self):
        imgs, homs, ext = batch(40, True, True)
        before = warp_cuda.split_warp.launches
        a = port_split(imgs, homs, ext, 'cuda')
        b = port_split(imgs, homs, ext, 'mxu')
        np.testing.assert_array_equal(a, b)
        assert warp_cuda.split_warp.launches == before   # no kernel ran

    def test_nhwc_output_is_planar_transposed(self):
        imgs, homs, ext = batch(41)
        planar = port_split(imgs, homs, ext, 'mxu')
        nhwc = warp.warp_batch_split(
            torch.as_tensor(imgs), torch.as_tensor(homs), (OUT, OUT),
            torch.as_tensor(ext), stage_b='mxu').numpy()
        np.testing.assert_array_equal(nhwc, planar.transpose(0, 2, 3, 1))


@pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float32'])
def test_warp_batch_mxu_matches(u8):
    """The exact two-pass warp on full canvases with smaller extents, f32
    operands on both sides; bound 1e-5 (f32 roundoff)."""
    imgs, homs, ext = batch(50 + u8, u8, True)
    src = imgs.astype(np.float32) / 255.0 if u8 else imgs
    ref = np.asarray(jwarp.warp_batch_mxu(
        jnp.asarray(src), jnp.asarray(homs), (OUT, OUT), jnp.asarray(ext)))
    ours = warp.warp_batch_mxu(torch.as_tensor(src), torch.as_tensor(homs),
                               (OUT, OUT), torch.as_tensor(ext)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize('impl', ['split', 'split_mxu', 'mxu', 'gather'])
def test_process_color_batch_matches(impl):
    """warp -> clip -> ImageNet normalise against JAX's process_color_batch
    (whose 'split' runs the matmul stage B on the CPU; 'gather' does not
    clip); bound 2e-4 on normalised values (warp roundoff <= 1e-5 / 0.225,
    times 4)."""
    imgs, homs, ext = batch(60, True, True)
    ref = np.asarray(jaugment.process_color_batch(
        jnp.asarray(imgs), jnp.asarray(homs), jnp.asarray(ext), None, OUT,
        False, False, warp_impl=impl))
    ours = augment.process_color_batch(
        torch.as_tensor(imgs), torch.as_tensor(homs), torch.as_tensor(ext),
        None, OUT, False, False, warp_impl=impl).numpy()
    assert ours.shape == (2, OUT, OUT, 3)
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_unported_augment_options_raise():
    imgs, homs, ext = (torch.as_tensor(a) for a in batch(61))
    with pytest.raises(NotImplementedError):
        augment.process_color_batch(imgs, homs, ext, None, OUT, True, False,
                                    warp_impl='split')
    with pytest.raises(NotImplementedError):
        augment.process_color_batch(imgs, homs, ext, None, OUT, False, True,
                                    warp_impl='gather')


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.delenv('NVCC', raising=False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cuda_build.find_nvcc()


@pytest.mark.parametrize('wdtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('small_extents', [False, True],
                         ids=['full', 'extents'])
def test_bound_counts_exactly_the_pixels_the_warp_reads(small_extents,
                                                        wdtype):
    """chip_smoke.split_warp_work, which the kernel's bound is computed
    from, marks the canvas pixels the split warp reads: changing every
    unmarked pixel leaves the crops bit for bit as they were, and changing
    one marked pixel changes them (checked on 20 sampled pixels; a pixel
    under four small weights may move a crop by less than one f32 step, so
    18 of 20 must)."""
    import chip_smoke
    imgs, homs, ext = batch(62 + small_extents, small_extents=small_extents)
    canv, ext_t = torch.as_tensor(imgs), torch.as_tensor(ext)
    residual, scale = warp.decompose_homography(torch.as_tensor(homs),
                                                (OUT, OUT), M)
    n_bytes, n_flops, read = chip_smoke.split_warp_work(
        canv, residual, scale, ext_t, (OUT, OUT), M)
    n_read = int(read.sum())
    assert n_bytes == n_read * 3 + 2 * 15 * 4 + 2 * 3 * OUT * OUT * 4
    assert 0 < n_read < read.numel() and n_flops > 0

    def crops(c):
        return warp_cuda.split_warp_plain(c, residual, scale, ext_t,
                                          (OUT, OUT), M, 1 / 255,
                                          getattr(torch, wdtype))

    ref = crops(canv)
    other = torch.where(read[..., None], canv, 255 - canv)
    assert torch.equal(crops(other), ref)
    idx = np.random.RandomState(64).choice(n_read, 20, replace=False)
    changed = 0
    for b, y, x in read.nonzero()[torch.as_tensor(idx)].tolist():
        one = canv.clone()
        one[b, y, x] = 255 - one[b, y, x]
        changed += not torch.equal(crops(one), ref)
    assert changed >= 18


def test_tile_footprints_hold_every_tap_of_their_tile():
    """warp_cuda.tile_footprints, the kernel's phase 1 on the host: stage B
    of each 16 x 32 output tile over the intermediate zeroed outside the
    tile's footprint gives that tile's crops bit for bit (every tap with
    nonzero weight lies inside: the zeroed terms had zero weight)."""
    imgs, homs, ext = batch(65, small_extents=True)
    residual, scale = warp.decompose_homography(torch.as_tensor(homs),
                                                (OUT, OUT), M)
    inter = warp.scale_resample_planar(torch.as_tensor(imgs), scale,
                                       torch.as_tensor(ext), M,
                                       torch.float32, 1 / 255)
    fp = warp_cuda.tile_footprints(residual, scale, torch.as_tensor(ext),
                                   (OUT, OUT), M)
    th, tw = warp_cuda.TILE
    assert fp.shape == (2, -(-OUT // th), -(-OUT // tw), 4)

    def stage_b(planar):
        return warp.warp_batch_mxu(planar.permute(0, 2, 3, 1), residual,
                                   (OUT, OUT), wdtype=torch.float32)

    ref = stage_b(inter)
    for b, ty, tx in np.ndindex(*fp.shape[:3]):
        p0, p1, q0, q1 = fp[b, ty, tx].tolist()
        assert 0 <= p0 <= p1 < M and 0 <= q0 <= q1 < M
        masked = torch.zeros_like(inter)
        masked[b, :, p0:p1 + 1, q0:q1 + 1] = inter[b, :, p0:p1 + 1,
                                                   q0:q1 + 1]
        got = stage_b(masked)
        rows, cols = slice(ty * th, (ty + 1) * th), slice(tx * tw,
                                                          (tx + 1) * tw)
        assert torch.equal(got[b, rows, cols], ref[b, rows, cols])


@pytest.mark.parametrize('stream', ['rgb', 'depth'])
def test_realistic_tiles_fit_the_kernel_budget(stream):
    """Every output tile of 32 seeded batches of 8 crops drawn like the
    loader's (chip_smoke.realistic_homs; each batch admitted by the split
    gate) stages within warp_cuda.SMEM_BUDGET: the RGB stream's 512^2
    uint8 canvases and the depth stream's 424 x 512 f32 ones, 257^2 crops.
    So the kernel's over-budget counter stays 0 on the main paths. A whole
    512^2 canvas squeezed into a 65^2 crop is over the budget."""
    import chip_smoke
    rng = np.random.RandomState(66 + (stream == 'depth'))
    side = 257
    m = warp.split_defaults((side, side))[0]
    hw, n_ch, elem = (((512, 512), 3, 1) if stream == 'rgb'
                      else ((424, 512), 1, 4))
    worst = 0
    for _ in range(32):
        homs = chip_smoke.realistic_homs(rng, 8, hw[0], side)
        assert warp.split_band_ok(homs, (side, side))
        ext = torch.tensor([hw] * 8, dtype=torch.int32)
        residual, scale = warp.decompose_homography(torch.as_tensor(homs),
                                                    (side, side), m)
        fp = warp_cuda.tile_footprints(residual, scale, ext, (side, side), m)
        need = warp_cuda.staged_bytes(fp, scale, ext, n_ch, elem)
        worst = max(worst, int(need.max()))
        assert warp_cuda.over_budget_count(residual, scale, ext,
                                           (side, side), m, n_ch, elem) == 0
    assert 0 < worst <= warp_cuda.SMEM_BUDGET
    whole = np.array([[[512 / OUT, 0, 0], [0, 512 / OUT, 0], [0, 0, 1]]],
                     np.float32)
    residual, scale = warp.decompose_homography(torch.as_tensor(whole),
                                                (OUT, OUT), M)
    ext = torch.tensor([[512, 512]], dtype=torch.int32)
    assert warp_cuda.over_budget_count(residual, scale, ext, (OUT, OUT), M,
                                       3, 1) > 0
