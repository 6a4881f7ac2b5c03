"""B8b's tile schedule and P's one-launch probe, emulated on CPU.

The CUDA kernels cannot run here, so plain numpy repeats what they do and
is held to the twins the card holds the kernels to, and to the JAX
kernels in interpret mode:

- B8b (``csrc/wmajor.cu transpose_kernel``): a frame as a matrix
  transpose with a regroup; tiles of XT_H rows h by XT_ROW_BYTES bytes of
  the (x, d) span, wherever the x boundaries fall; input rows copied into
  a shared tile whose 16-byte chunks are swapped by ``k ^ ((r / EPC) &
  7)`` (16 bytes at a time where a row is a multiple of 16 bytes, else
  element by element, unloaded bytes left as garbage); EPC x EPC blocks
  read back, rows past the valid ones as zero, transposed in registers
  (``__byte_perm`` on 2-byte pairs) and written 16 bytes at a time or
  element by element; padding-only tiles read nothing and write zeros.
  Bit-equal to ``transpose_to_wmajor_plain`` / ``transpose_from_wmajor_plain``
  and to JAX ``transpose_to_wmajor`` / ``transpose_from_wmajor``.
- P (``csrc/probe_i16.cu``): the six toy ops of the JAX probe in one pass,
  eight elements a thread, the roll's neighbour from the element before
  (or the row's last one), planes n rounded up to 8 apart. Bit-equal to
  the torch expressions and to the JAX probe's toy kernels.
"""

import importlib.util
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video3d_tpu.kernels.sgm import transpose_from_wmajor, transpose_to_wmajor
from video3d_tpu_torch.kernels import _build, wmajor
from video3d_tpu_torch.tools import probe_i16

XT_H, XT_ROW_BYTES = 64, 256  # B8b's tile, as csrc/wmajor.cu has it
TILES_A_STEP = 128  # tiles emulated at once (memory)


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA ``__byte_perm(x, y, sel)`` on uint32 arrays: byte n of the
    result is byte ``(sel >> 4n) & 7`` of the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint64)
    for n in range(4):
        src = (sel >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(
            8 * n)
    return out.astype(np.uint32)


def xpose_chunks(a: np.ndarray, es: int) -> np.ndarray:
    """The kernel's register transpose of EPC chunks (..., EPC, EPC) of
    ``es``-byte elements, on the 32-bit words the chunks are held in:
    o[i] element j = a[j] element i."""
    epc = 16 // es
    if es == 4:  # register renaming
        return np.swapaxes(a, -1, -2).copy()
    w = a.view(np.uint32).reshape(a.shape[:-1] + (4,))  # (..., 8, 4) words
    o = np.empty_like(w)
    for i in range(epc):
        sel = 0x7632 if i & 1 else 0x5410
        for p in range(4):
            o[..., i, p] = byte_perm(w[..., 2 * p, i >> 1],
                                     w[..., 2 * p + 1, i >> 1], sel)
    return o.view(a.dtype).reshape(a.shape)


def b8b_schedule(x: np.ndarray, h: int, hp: int, to: bool,
                 vec=None) -> np.ndarray:
    """``transpose_kernel`` on ``x`` (TO: (B, H, W, D) -> (B, D, W, HP);
    else (B, D, W, HP) -> (B, H, W, D)), tile by tile. ``vec`` forces
    both sides to 16-byte (True) or element-wise (False) accesses; None
    takes the kernel's rule (a side's rows a multiple of 16 bytes)."""
    es = x.dtype.itemsize
    epc, cw = 16 // es, XT_ROW_BYTES // es
    bits = x.view(np.uint16 if es == 2 else np.uint32).ravel()
    garbage = bits.dtype.type(0xBEEF if es == 2 else 0xDEADBEEF)
    if to:
        b, _, w, d = x.shape
        out = np.full((b, d, w, hp), garbage, dtype=bits.dtype)
    else:
        b, d, w, _ = x.shape
        out = np.full((b, h, w, d), garbage, dtype=bits.dtype)
    flat = out.ravel()
    wd = w * d
    nr = XT_H if to else cw            # input rows a tile
    nc = (cw if to else XT_H) // epc   # 16-byte chunks an input row
    nrb = nr // epc                    # chunks an output row
    n_ht = -(-(hp if to else h) // XT_H)
    n_ct = -(-wd // cw)
    rows_h, rows_c = hp * es % 16 == 0, wd * es % 16 == 0
    vec_in = (rows_c if to else rows_h) if vec is None else vec
    vec_out = (rows_h if to else rows_c) if vec is None else vec
    tiles = b * n_ht * n_ct
    r = np.arange(nr)[None, :, None]
    e = np.arange(nc * epc)[None, None, :]
    for g0 in range(0, tiles, TILES_A_STEP):
        g = np.arange(g0, min(tiles, g0 + TILES_A_STEP))[:, None, None]
        c0 = (g % n_ct) * cw
        h0 = (g // n_ct) % n_ht * XT_H
        tb = g // (n_ct * n_ht)
        cols = np.minimum(cw, wd - c0)
        if to:
            t_nr = np.clip(h - h0, 0, XT_H)
            t_ne, t_len = cols, np.minimum(XT_H, hp - h0)
        else:
            t_nr, t_ne, t_len = cols, np.minimum(XT_H, h - h0), cols
        # copy in: the swizzled shared tile, garbage where nothing landed
        smem = np.full((g.shape[0], nr * nc * epc), garbage, dtype=bits.dtype)
        if vec_in:
            load = (r < t_nr) & ((e // epc) * epc < t_ne)
        else:
            load = (r < t_nr) & (e < t_ne)
        if to:
            src = (tb * h + h0 + r) * wd + c0 + e
        else:
            c = c0 + r
            src = ((tb * d + c % d) * w + c // d) * hp + h0 + e
        dst = (r * nc + ((e // epc) ^ ((r // epc) & 7))) * epc + e % epc
        ti = np.broadcast_to(np.arange(g.shape[0])[:, None, None], load.shape)
        smem[ti[load], np.broadcast_to(dst, load.shape)[load]] = \
            bits[np.broadcast_to(src, load.shape)[load]]
        # EPC x EPC blocks (rb, kb): rows rb * EPC + j, chunk kb, rows past
        # the valid ones as zero; transposed; output row kb * EPC + i
        rb = np.arange(nrb)[None, :, None, None, None]
        kb = np.arange(nc)[None, None, :, None, None]
        j = np.arange(epc)[None, None, None, :, None]
        q = np.arange(epc)[None, None, None, None, :]
        rr = rb * epc + j
        pos = (rr * nc + (kb ^ (rb & 7))) * epc + q
        ti = np.arange(g.shape[0])[:, None, None, None, None]
        a = np.where(rr < t_nr[..., None, None], smem[ti, pos], 0).astype(
            bits.dtype)
        o = xpose_chunks(a, es)  # (tiles, rb, kb, i, j)
        i_ = np.arange(epc)[None, None, None, :, None]
        j_ = np.arange(epc)[None, None, None, None, :]
        e_out = kb * epc + i_
        el = rb * epc + j_
        cg, hg, bg = (v[..., None, None] for v in (c0, h0, tb))
        if vec_out:
            keep = (e_out < t_ne[..., None, None]) & (
                rb * epc < t_len[..., None, None])
        else:
            keep = (e_out < t_ne[..., None, None]) & (
                el < t_len[..., None, None])
        if to:
            cc = cg + e_out
            dsto = ((bg * d + cc % d) * w + cc // d) * hp + hg + el
        else:
            dsto = (bg * h + hg + e_out) * wd + cg + el
        keep = np.broadcast_to(keep, o.shape)
        flat[np.broadcast_to(dsto, o.shape)[keep]] = o[keep]
    return out.view(x.dtype)


# (batch, height, width, D): every height (128: H = HP, no padding row)
# with every width, D cycling through 1, 17, 40, 64 and 128
B8B_SHAPES = [(1 + k % 2, h, w, (1, 17, 40, 64, 128)[k % 5])
              for k, (h, w) in enumerate(itertools.product(
                  (1, 40, 64, 70, 128, 130), (1, 3, 90, 257)))]
DTYPES = {"int16": np.int16, "f32": np.float32}


def _volume(seed, shape, dtype):
    r = np.random.default_rng(seed)
    if dtype == np.int16:
        return r.integers(-32768, 32768, shape).astype(np.int16)
    return r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", B8B_SHAPES, ids=str)
def test_b8b_schedule_bit_equal_to_twins(shape, dtype):
    """Both directions of B8b's schedule, on the kernel's own choice of
    16-byte or element-wise sides and on the element-wise path forced
    (the kernel's path for storage that is not 16-byte aligned), equal the
    plain twins bit for bit; the inverse reads a volume whose padding rows
    hold garbage, which must not reach its output."""
    b, h, w, d = shape
    x = _volume(23, shape, DTYPES[dtype])
    hp = wmajor.padded_rows(h)
    want_t = wmajor.transpose_to_wmajor_plain(torch.from_numpy(x)).numpy()
    garbage = want_t.copy()
    garbage[..., h:] = _volume(24, garbage[..., h:].shape, DTYPES[dtype])
    for vec in (None, False):
        got_t = b8b_schedule(x, h, hp, True, vec)
        np.testing.assert_array_equal(got_t.view(np.uint8),
                                      want_t.view(np.uint8))
        back = b8b_schedule(garbage, h, hp, False, vec)
        assert back.shape == x.shape
        np.testing.assert_array_equal(back.view(np.uint8), x.view(np.uint8))
    assert torch.equal(wmajor.transpose_from_wmajor_plain(
        torch.from_numpy(garbage), h), torch.from_numpy(x))


def test_b8b_schedule_paths_and_padding_tiles():
    """At 1080p-like rows (H = 130, HP = 256, D = 64) the kernel's rule
    takes 16-byte accesses on both sides, the last tile of rows lies
    wholly in the padding and is written as zeros, and the tiles hold 128
    int16 columns: two x at D = 64, one at D = 128."""
    x = _volume(25, (1, 130, 6, 64), np.int16)
    hp = wmajor.padded_rows(130)
    assert hp == 256 and -(-hp // XT_H) == 4 and 130 < 3 * XT_H
    assert (hp * 2) % 16 == 0 and (6 * 64 * 2) % 16 == 0  # both sides vector
    got = b8b_schedule(x, 130, hp, True)
    assert not got[..., 3 * XT_H:].any() and not got[..., 130:].any()
    assert XT_ROW_BYTES // 2 // 64 == 2 and XT_ROW_BYTES // 2 // 128 == 1


@pytest.mark.parametrize("h,w,d,dtype", [
    (40, 128, 17, "int16"), (130, 128, 64, "int16"), (64, 256, 8, "int16"),
    (128, 128, 17, "f32"), (128, 256, 40, "f32")])
def test_b8b_schedule_matches_jax(h, w, d, dtype):
    """Where the JAX kernels run (W a multiple of 128, their grid), the
    schedule equals them in interpret mode: rows h < H of the W-major
    volume (JAX leaves the padding rows as garbage by contract), and the
    inverse. Their bf16 hi/lo split is exact for integers in [0, 2^15).
    In f32, H = HP: the JAX kernel's identity matmul spreads the NaNs that
    interpret mode reads past H over every row."""
    r = np.random.default_rng(26)
    x = r.integers(0, 30000, (2, h, w, d)).astype(DTYPES[dtype])
    hp = wmajor.padded_rows(h)
    want = np.asarray(transpose_to_wmajor(
        jnp.asarray(x.transpose(0, 1, 3, 2)), interpret=True))  # (B,D,W,HP)
    got = b8b_schedule(x, h, hp, True)
    np.testing.assert_array_equal(got[..., :h], want[..., :h])
    back_jax = np.asarray(transpose_from_wmajor(jnp.asarray(want), h,
                                                interpret=True))
    back = b8b_schedule(got, h, hp, False)
    np.testing.assert_array_equal(back.transpose(0, 1, 3, 2), back_jax)
    np.testing.assert_array_equal(back, x)


def _wmajor_constants():
    src = (_build._SRC_DIR / "wmajor.cu").read_text()
    return src, {name: int(v) for name, v in re.findall(
        r"constexpr int (XT_\w+) = (\d+);", src)}


def test_b8b_tile_constants_pinned_to_source():
    """The emulation's tile is the kernel's: XT_H rows by XT_ROW_BYTES, the
    chunk swap of the shared tile, 8x8 / 4x4 blocks."""
    src, consts = _wmajor_constants()
    assert consts["XT_H"] == XT_H and consts["XT_ROW_BYTES"] == XT_ROW_BYTES
    assert "return r * NC + (k ^ ((r / EPC) & 7));" in src
    assert "const int rb = q % NRB, kb = q / NRB;" in src
    assert "const int r = i / NC, k = i % NC;" in src
    assert "(i & 1) ? 0x7632 : 0x5410" in src


@pytest.mark.parametrize("es,to", [(2, True), (2, False), (4, True),
                                   (4, False)])
def test_b8b_shared_tile_bank_conflict_free(es, to):
    """16-byte shared accesses go a quarter warp (8 threads) at a time; the
    kernel's thread maps put those 8 threads on 8 different 16-byte bank
    groups (chunk mod 8) when they copy a tile in and when they read their
    blocks back, and a quarter warp's stores cover 128 contiguous bytes."""
    _, consts = _wmajor_constants()
    threads = consts["XT_THREADS"]
    epc, cw = 16 // es, XT_ROW_BYTES // es
    nr, nc = (XT_H, cw // epc) if to else (cw, XT_H // epc)
    nrb = nr // epc

    def chunk(r, k):
        return r * nc + (k ^ ((r // epc) & 7))

    for t0 in range(0, nr * nc, 8):  # copy in: i -> (i / NC, i % NC)
        groups = {chunk(i // nc, i % nc) % 8 for i in range(t0, t0 + 8)}
        assert len(groups) == 8
    for q0 in range(0, nrb * nc, 8):  # blocks: q -> (q % NRB, q / NRB)
        qs = range(q0, q0 + 8)
        for j in range(epc):
            groups = {chunk((q % nrb) * epc + j, q // nrb) % 8 for q in qs}
            assert len(groups) == 8
        # output chunk rb of one output row: 8 x 16 contiguous bytes
        assert len({q // nrb for q in qs}) == 1
        assert sorted(q % nrb for q in qs) == list(range(q0 % nrb,
                                                         q0 % nrb + 8))
    # a block's threads take whole blocks: none left over, none idle
    assert (nrb * nc) % threads == 0


@pytest.mark.parametrize("es", [2, 4])
def test_b8b_register_transpose(es):
    """The ``__byte_perm`` transpose of 8x8 int16 (and the renaming of 4x4
    f32) is the transpose, bit for bit."""
    r = np.random.default_rng(27)
    epc = 16 // es
    a = r.integers(0, 2 ** (8 * es), (5, epc, epc)).astype(
        np.uint16 if es == 2 else np.uint32)
    np.testing.assert_array_equal(xpose_chunks(a, es), a.swapaxes(1, 2))


# ---------------------------------------------------------------------------
# P: the six probe ops in one launch
# ---------------------------------------------------------------------------


def p_kernel_order(xs, mask: int) -> list:
    """``probe_kernel`` on int16 numpy inputs: eight elements a thread
    (the tail chunk element by element, its missing elements zero), each
    op asked for into its plane (planes n rounded up to 8 apart), the roll's
    neighbour from the element before in the chunk, from the element
    before the chunk, or at a row's first column from the row's last."""
    a = xs[0].ravel()
    shape, n, last = xs[0].shape, xs[0].size, xs[0].shape[-1]
    ps = -(-n // 8) * 8
    pad = [np.concatenate([x.ravel(), np.zeros(ps - n, np.int16)]).reshape(
        -1, 8) for x in xs]
    va = pad[0]
    vb = pad[1] if len(xs) > 1 else None
    vc = pad[2] if len(xs) > 2 else None
    i = np.arange(ps).reshape(-1, 8)
    k = i % 8
    col = i % last
    out = []
    with np.errstate(over="ignore"):
        if mask & 1:
            out.append(va + vb)
        if mask & 2:
            out.append((va + vb) - vc)
        if mask & 4:
            out.append(np.where(col < 4, va, vb))
        if mask & 8:
            out.append(np.clip(va.astype(np.float32) * 2.0, -32768,
                               32767).astype(np.int32).astype(np.int16))
        if mask & 16:
            safe = np.minimum(i, n - 1)
            row_last = a[np.minimum(safe + last - 1, n - 1)]
            before = np.concatenate([[0], a])[np.minimum(i, n)]  # a[i - 1]
            in_regs = np.roll(va, 1, axis=1)
            prev = np.where(col == 0, row_last,
                            np.where(k > 0, in_regs, before))
            out.append(prev.astype(np.float32).astype(np.int16))
        if mask & 32:
            out.append((va >> 1) + (va & 1))
    planes = np.full((len(out), ps), 0x5A5A, dtype=np.int16)
    for p, o in enumerate(out):
        planes[p, :n] = o.ravel()[:n]
    return [pl_[:n].reshape(shape) for pl_ in planes]


@pytest.fixture(scope="module")
def jax_toys():
    """name -> toy kernel of the JAX probe, taken from its own ``main`` (the
    toy bodies are nested there) by intercepting ``run``."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_i16.py"
    spec = importlib.util.spec_from_file_location("_jax_probe_i16_p", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = {}
    mod.run = lambda name, kernel, n_in, **_: kernels.update({name: kernel})
    mod.main()
    return kernels


def _jax_op(kernel, xs):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(xs[0].shape, jnp.int16),
        interpret=True)(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("full_range", [False, True])
def test_probe_all_matches_jax_probe(jax_toys, full_range):
    """``probe_all`` (on CPU its torch expressions) gives the six outputs
    of the JAX probe's toy kernels, in order, bit for bit, and so does the
    kernel's order of work on the same inputs."""
    xs = probe_i16.probe_inputs("cpu", 7, full_range)
    got = probe_i16.probe_all(*xs)
    order = p_kernel_order([x.numpy() for x in xs], 63)
    assert len(got) == len(order) == 6 == len(jax_toys)
    for k, (name, (_, n_in, _)) in enumerate(probe_i16.OPS.items()):
        want = _jax_op(jax_toys[name], [x.numpy() for x in xs[:n_in]])
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=name)
        np.testing.assert_array_equal(order[k], want, err_msg=name)


@pytest.mark.parametrize("name", list(probe_i16.OPS))
def test_probe_op_is_its_mask_bit(name):
    """``probe_op`` is one op's bit of the mask: a single plane, equal to
    that op's output of ``probe_all``, and in the kernel's order too."""
    xs = probe_i16.probe_inputs("cpu", 8, True)
    code, n_in, _ = probe_i16.OPS[name]
    alone = probe_i16.probe_all_plain(xs[:n_in], 1 << code)
    assert len(alone) == 1
    k = list(probe_i16.OPS).index(name)
    assert k == code
    assert torch.equal(probe_i16.probe_op(name, *xs[:n_in]),
                       probe_i16.probe_all(*xs)[k])
    assert torch.equal(alone[0], probe_i16.probe_all(*xs)[k])
    order = p_kernel_order([x.numpy() for x in xs[:n_in]], 1 << code)
    assert len(order) == 1
    np.testing.assert_array_equal(order[0], alone[0].numpy())
    with pytest.raises(ValueError):
        probe_i16.probe_op(name, *xs[:n_in - 1])


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 3, 9), (1, 1, 8),
                                   (4, 2, 3), (1, 1, 1), (2, 4, 13)],
                         ids=str)
def test_probe_ragged_shapes(jax_toys, shape):
    """At shapes whose size and last axis are no multiple of 8 (and rows
    shorter than the select's 4 columns) the kernel's order of work (tail
    chunk, the roll's neighbour across chunks and rows) equals the torch
    expressions and the JAX toy kernels."""
    r = np.random.default_rng(9)
    xs = [r.integers(-32768, 32768, shape).astype(np.int16)
          for _ in range(3)]
    want = probe_i16.probe_all_plain([torch.from_numpy(x) for x in xs])
    order = p_kernel_order(xs, 63)
    for k, (name, (_, n_in, _)) in enumerate(probe_i16.OPS.items()):
        np.testing.assert_array_equal(order[k], want[k].numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(
            _jax_op(jax_toys[name], xs[:n_in]), want[k].numpy(),
            err_msg=name)
