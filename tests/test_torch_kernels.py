"""The kernel wrappers (forward fill, hang AGC, column FFT): their argument
checks, which both implementations share, numpy models of the three
kernels' schedules (the index arithmetic of csrc/ffill.cu and
csrc/pstock.cu, the tiles and ring of csrc/agc.cu, checked here where no
kernel can run), and on a card each
Hopper kernel against its plain version: the fill and the AGC bit-exact
(selects, and IEEE float32 steps with no a*b+c), the column FFT within 2e-6
of the spectrum's peak (twiddles rounded differently).

This file imports no jax, so it also runs where jax is not installed, as on
the machine with the card (``tests/conftest.py`` configures jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.ops import agc as TA
from ka9q_sdr_tpu_torch.ops import ffill as TFF
from ka9q_sdr_tpu_torch.ops import pstock as TP

torch.set_num_threads(1)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "conj",
                                 "neg", "mask_dtype", "too_many"])
def test_fill_rejects_what_the_kernel_does_not_take(bad):
    """Both implementations check their arguments alike, so a call that the
    kernel would refuse on the card fails on the CPU too."""
    v = torch.zeros((4, 16), dtype=torch.complex64)
    m = torch.ones((4, 16), dtype=torch.bool)
    values, inits = (v,), (0.0,)
    if bad == "dtype":
        values = (v.real.to(torch.float64).contiguous(),)
    elif bad == "shape":
        values = (v[:, :8].contiguous(),)
    elif bad == "strided":
        values = (torch.zeros((4, 32), dtype=torch.complex64)[:, ::2],)
    elif bad == "conj":        # a conj view the kernel could not read in runs
        values = (torch.conj(torch.zeros((4, 32), dtype=torch.complex64)
                             [:, ::2]),)
    elif bad == "neg":
        values = (torch._neg_view(v.real.contiguous()),)
    elif bad == "mask_dtype":
        m = m.to(torch.uint8)
    elif bad == "too_many":
        values, inits = (v,) * 5, (0.0,) * 5
    with pytest.raises((TypeError, ValueError)):
        TFF.forward_fill_multi(values, m, inits)


def test_fill_takes_a_conj_view():
    """A conj view of a contiguous complex value fills exactly as its
    conj_physical copy does, beside a float value in the same call."""
    rng = np.random.default_rng(5)
    c = torch.as_tensor((rng.standard_normal((6, 40)) + 1j
                         * rng.standard_normal((6, 40))).astype(np.complex64))
    v = torch.as_tensor(rng.standard_normal((6, 40)).astype(np.float32))
    m = torch.as_tensor(rng.random((6, 40)) < 0.5)
    m[0] = False
    ic = torch.as_tensor(np.full(6, 0.5 - 2j, np.complex64))
    got = TFF.forward_fill_multi((torch.conj(c), v), m, (ic, 1.0))
    want = TFF.forward_fill_multi((torch.conj_physical(c), v), m, (ic, 1.0))
    assert not got[0].is_conj()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0][0], ic[0].expand(40))      # all weak: the init


_LANES, _RUN = 32, 8


def _fill_schedule(values, conjs, mask, inits):
    """csrc/ffill.cu's schedule in numpy: flat runs of 8 positions aligned
    to the arrays' start, a warp of 32 runs per chunk along each row, the
    nearest earlier lane with a strong position (the ballot) or the carry
    for a run's weak head."""
    B, T = mask.shape
    flat_m = mask.reshape(-1)
    flat_v = [np.conj(v).reshape(-1) if cj else v.reshape(-1)
              for v, cj in zip(values, conjs)]
    outs = [np.zeros_like(f) for f in flat_v]
    for row in range(B):
        lo, hi = row * T, row * T + T
        carry = [init[row] for init in inits]
        r0 = lo // _RUN
        while r0 * _RUN < hi:
            runs = [[g for g in range((r0 + lane) * _RUN,
                                      (r0 + lane + 1) * _RUN) if lo <= g < hi]
                    for lane in range(_LANES)]
            strong = [[g for g in run if flat_m[g]] for run in runs]
            has = [bool(st) for st in strong]
            for i, f in enumerate(flat_v):
                last = [f[st[-1]] if st else None for st in strong]
                for lane, run in enumerate(runs):
                    below = [j for j in range(lane) if has[j]]
                    prev = last[below[-1]] if below else carry[i]
                    for g in run:
                        if flat_m[g]:
                            prev = f[g]
                        outs[i][g] = prev
                if any(has):
                    carry[i] = last[max(j for j in range(_LANES) if has[j])]
            r0 += _LANES
    return [o.reshape(B, T) for o in outs]


def _fill_rows(B, T, seed):
    """A mask with random rows and rows that are all weak, all strong, or
    strong only at the last position."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, T)) < 0.3
    m[0::4] = False
    m[1::4] = True
    m[2::4] = False
    m[2::4, -1] = True
    return m


@pytest.mark.parametrize("T", [1, 7, 8, 9, 31, 33, 255, 257, 1025])
def test_fill_schedule_matches_plain(T):
    """The kernel's index schedule, run in numpy, against the plain version
    for a float, a complex and a conj-view value, at ragged T (rows start
    anywhere inside a run)."""
    B = 7
    rng = np.random.default_rng(T)
    m = _fill_rows(B, T, T)
    v = rng.standard_normal((B, T)).astype(np.float32)
    c = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    iv = rng.standard_normal(B).astype(np.float32)
    ic = (rng.standard_normal(B) + 1j * rng.standard_normal(B)).astype(
        np.complex64)
    got = _fill_schedule((v, c, c), (False, False, True), m, (iv, ic, ic))
    tc = torch.as_tensor(c)
    want = TFF.forward_fill_multi(
        (torch.as_tensor(v), tc, torch.conj(tc)), torch.as_tensor(m),
        (torch.as_tensor(iv), torch.as_tensor(ic), torch.as_tensor(ic)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    (got,) = _fill_schedule((v,), (False,), m, (iv,))       # float only
    np.testing.assert_array_equal(got, want[0].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 130, 3072, 4096])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 31, 33, 255, 257, 960, 1025,
                               7104])
def test_ffill_kernel_matches_plain_on_card(B, T):
    """One launch fills a float, a complex and a conj-view value sharing a
    mask with all-weak, all-strong and last-only rows (the all-weak rows
    take their init)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    v = rng.standard_normal((B, T)).astype(np.float32)
    c = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    m = _fill_rows(B, T, B + T)
    iv = rng.standard_normal(B).astype(np.float32)
    ic = (rng.standard_normal(B)
          + 1j * rng.standard_normal(B)).astype(np.complex64)
    v, c, m, iv, ic = (torch.as_tensor(a, device="cuda")
                       for a in (v, c, m, iv, ic))
    values, inits = (v, c, torch.conj(c)), (iv, ic, ic)
    before = TFF.launches
    got = TFF.forward_fill_multi(values, m, inits)
    want = TFF.fill_plain(values, m, inits)
    torch.cuda.synchronize()
    assert TFF.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [7, 960])
def test_ffill_kernel_on_offset_views_on_card(T):
    """Rows 1.. of larger tensors: at odd T the mask and values start off
    their 8- and 16-byte alignment, and every run goes position by
    position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(T)
    B = 65
    c = torch.randn((B + 1, T), generator=g, device="cuda",
                    dtype=torch.complex64)[1:]
    v = torch.randn((B + 1, T), generator=g, device="cuda")[1:]
    m = (torch.rand((B + 1, T), generator=g, device="cuda") < 0.5)[1:]
    init = torch.zeros((B,), device="cuda")
    ic = torch.zeros((B,), device="cuda", dtype=torch.complex64)
    got = TFF.forward_fill_multi((v, torch.conj(c)), m, (init, ic))
    want = TFF.fill_plain((v, torch.conj(c)), m, (init, ic))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "gain_shape", "hang_dtype",
                                 "empty"])
def test_agc_rejects_what_the_kernel_does_not_take(bad):
    params = TA.AGCParams.from_mode(-15.0, 6.0, 1.1, 1.0 / 48000)
    lev = torch.ones((4, 16))
    st = TA.agc_init(100.0, (4,), device="cpu")
    if bad == "dtype":
        lev = lev.to(torch.float64)
    elif bad == "gain_shape":
        st = st._replace(gain=torch.ones(5))
    elif bad == "hang_dtype":
        st = st._replace(hangcount=torch.zeros(4, dtype=torch.int64))
    elif bad == "empty":
        lev = torch.ones((4, 0))
    with pytest.raises((TypeError, ValueError)):
        TA.agc_block(st, lev, params)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "devices"])
def test_fft_cols_rejects_what_the_kernel_does_not_take(bad):
    f = TP.make_fft_cols(16, 8, 8)
    xr, xi = torch.zeros((16, 8)), torch.zeros((16, 8))
    if bad == "dtype":
        xr = xr.to(torch.float64)
    elif bad == "shape":
        xr = torch.zeros((8, 16))
    elif bad == "strided":
        xr = torch.zeros((16, 16))[:, ::2]
    elif bad == "devices":
        xr = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError):
        f(xr, xi)


def _agc_case(B, T, seed):
    """Levels over 60 dB with zero runs; a NaN gain on a zero level (the
    gain goes inf), hang counts above zero at entry."""
    rng = np.random.default_rng(seed)
    lev = (10.0 ** rng.uniform(-4, -1, (B, T))).astype(np.float32)
    lev[:, T // 3: T // 3 + 5] = 0.0
    gain = (10.0 ** rng.uniform(0, 5, B)).astype(np.float32)
    gain[::7] = np.nan
    lev[::7, :3] = 0.0
    hang = rng.integers(0, 40, B).astype(np.int32)
    return lev, gain, hang


#: the AM (hangmax 0), linear (52800) and CW (9600) parameters at 48 kHz
_AGC_MODES = (TA.AGCParams.from_mode(-15.0, 50.0, 0.0, 1 / 48000),
              TA.AGCParams.from_mode(-15.0, 6.0, 1.1, 1 / 48000),
              TA.AGCParams.from_mode(-15.0, 20.0, 0.2, 1 / 48000))

#: csrc/agc.cu's tile of samples, channels per block, ring stages and tiles
#: loaded ahead
_AGC_S, _AGC_LANES, _AGC_STAGES, _AGC_AHEAD = 64, 32, 4, 2


def _agc_schedule(lev, gain, hang, params):
    """csrc/agc.cu's schedule in numpy: blocks of 32 channels (dead lanes
    read 1.0 and write nothing), tiles of S samples through a ring of
    stages, each tile's clamps divided when it lands, before the walker
    reaches it; the walker walks whole tiles, then a masked last tile that
    keeps the carry past the row's end; a stage is refilled only after its
    tile was walked and stored (asserted, as the mbarriers enforce it)."""
    S, L, NST = _AGC_S, _AGC_LANES, _AGC_STAGES
    headroom = np.float32(params.headroom)
    recovery = np.float32(params.recovery_factor)
    hangmax = np.int32(params.hangmax)
    B, T = lev.shape
    ntiles = -(-T // S)
    out = np.full((B, T), -1.0, np.float32)
    g_out, h_out = np.empty(B, np.float32), np.empty(B, np.int32)
    for b0 in range(0, B, L):
        rows = min(L, B - b0)
        ring = {name: np.full((NST, L, S), np.nan, np.float32)
                for name in ("lev", "clamp", "gain")}
        full, walked = [None] * NST, [None] * NST
        g = np.zeros(L, np.float32)
        h = np.zeros(L, np.int32)
        g[:rows], h[:rows] = gain[b0:b0 + rows], hang[b0:b0 + rows]
        walker = [0]                     # the next tile the walker takes

        def load(k):
            assert walked[k % NST] in (None, k - NST)
            tile = np.ones((L, S), np.float32)
            n = min(S, T - k * S)
            tile[:rows, :n] = lev[b0:b0 + rows, k * S:k * S + n]
            ring["lev"][k % NST] = tile

        def walk_to(k):
            nonlocal g, h
            while walker[0] <= k:
                j = walker[0]
                s = j % NST
                assert full[s] == j, "the walker would wait forever"
                n = min(S, T - j * S)
                for i in range(S):
                    lv, cl = ring["lev"][s, :, i], ring["clamp"][s, :, i]
                    over = lv * g > headroom
                    bad = np.isnan(g)
                    ng = np.where(bad | over, cl,
                                  np.where(h > 0, g, g * recovery))
                    nh = np.where(over & ~bad, hangmax,
                                  np.maximum(h - 1, 0)).astype(np.int32)
                    if i < n:                # the masked walk keeps the carry
                        g, h = ng, nh
                    ring["gain"][s, :, i] = g
                walked[s] = j
                walker[0] += 1

        def store(k):
            walk_to(k)
            n = min(S, T - k * S)
            out[b0:b0 + rows, k * S:k * S + n] = \
                ring["gain"][k % NST, :rows, :n]

        with np.errstate(all="ignore"):
            for k in range(min(_AGC_AHEAD, ntiles)):
                load(k)
            for k in range(ntiles):
                nxt = k + _AGC_AHEAD
                if nxt < ntiles:
                    if nxt >= NST:
                        store(nxt - NST)
                    load(nxt)
                ring["clamp"][k % NST] = headroom / ring["lev"][k % NST]
                full[k % NST] = k
            for k in range(max(0, ntiles - NST), ntiles):
                store(k)
        g_out[b0:b0 + rows], h_out[b0:b0 + rows] = g[:rows], h[:rows]
    return out, g_out, h_out


@pytest.mark.parametrize("B", [1, 7, 33, 130])
@pytest.mark.parametrize("T", sorted({1, 7, 31, _AGC_S - 1, _AGC_S,
                                      _AGC_S + 1, 391, 960, 1025}))
def test_agc_schedule_matches_plain(B, T):
    """The kernel's schedule, run in numpy, bit-equal to the plain loop:
    zero levels (inf clamps), NaN gains at entry, and hang counts that cross
    tile and stage boundaries under the AM, linear and CW parameters and a
    hang of 45 samples that expires inside the block."""
    lev, gain, hang = _agc_case(B, T, seed=B * T)
    short = TA.AGCParams(_AGC_MODES[1].headroom,
                         _AGC_MODES[1].recovery_factor, 45)
    for params in _AGC_MODES + (short,):
        got, g, h = _agc_schedule(lev, gain, hang, params)
        want, wg, wh = TA.agc_plain(torch.as_tensor(gain),
                                    torch.as_tensor(hang),
                                    torch.as_tensor(lev), params)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(g, wg.numpy())
        np.testing.assert_array_equal(h, wh.numpy())


def _agc_kernel_matches_plain(lev, gain, hang, params):
    before = TA.launches
    st, got = TA.agc_block(TA.AGCState(gain, hang), lev, params)
    want, g, h = TA.agc_plain(gain, hang, lev, params)
    torch.cuda.synchronize()
    assert TA.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(st.gain, g) and torch.equal(st.hangcount, h)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 256), (7, 100), (130, 391),
                                 (4096, 960), (1, 960), (512, 960),
                                 (8192, 7104)])
def test_agc_kernel_matches_plain_on_card(B, T):
    """Every shape under the AM and CW parameters; all but the largest
    under the linear ones too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lev, gain, hang = (torch.as_tensor(a, device="cuda")
                       for a in _agc_case(B, T, seed=T))
    for params in _AGC_MODES:
        if B * T > 1 << 24 and params is _AGC_MODES[1]:
            continue                  # the plain loop is slow there
        _agc_kernel_matches_plain(lev, gain, hang, params)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [7, 391, 961])
def test_agc_kernel_on_offset_view_on_card(T):
    """Rows 1.. of a larger tensor at odd T: a contiguous view with a
    storage offset, whose rows start off any 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B = 45
    lev, gain, hang = _agc_case(B + 1, T, seed=T + 1)
    lev = torch.as_tensor(lev, device="cuda")[1:]
    assert lev.is_contiguous() and lev.storage_offset() == T
    gain, hang = (torch.as_tensor(a[1:], device="cuda") for a in (gain, hang))
    for params in _AGC_MODES:
        _agc_kernel_matches_plain(lev, gain, hang, params)


_ALL_Q = [1 << k for k in range(1, 15)]          # 2 .. MAX_Q = 16384
_RAGGED_P = 389      # 3 tiles of 128 columns + 5, 24 of 16 + 5, 48 of 8 + 5


def _dft_regs(a):
    """csrc/pstock.cu's in-register dft<R> on axis 0 of a complex64 array:
    the radix-2 autosorting Stockham recurrence with W16 constants in
    float32, natural order out."""
    r = a.shape[0]
    w16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)
    n, s = r, 1
    while n >= 2:
        m = n // 2
        y = np.empty_like(a)
        for p in range(m):
            for j in range(s):
                x0, x1 = a[p * s + j], a[(p + m) * s + j]
                y[2 * p * s + j] = x0 + x1
                y[(2 * p + 1) * s + j] = (x0 - x1) * w16[p * (16 // n)]
        a, n, s = y, m, 2 * s
    return a


def _stockham_schedule(x, plan, table):
    """csrc/pstock.cu's passes in numpy: butterfly b = p s + j reads
    x[q Q/r + b], q < r, and writes its twiddled DFT to y[(p r + k) s + j]."""
    Q = x.shape[0]
    y, s = x.astype(np.complex64), 1
    for n, r in enumerate(plan):
        b = np.arange(Q // r)
        p, j = b // s, b % s
        k = np.arange(r)[:, None]
        out = _dft_regs(y[k * (Q // r) + b])
        if n < len(plan) - 1:      # the table at p s 2^m, multiplied
            w = np.ones((r, len(b)), np.complex64)
            for bit in range(r.bit_length() - 1):
                on = (np.arange(r) >> bit) & 1 == 1
                w[on] *= table[(p * s) << bit]
            out = out * w[..., None]
        new = np.empty_like(y)
        new[(p * r + k) * s + j] = out
        y, s = new, s * r
    return y


@pytest.mark.parametrize("Q", _ALL_Q)
def test_stockham_schedule_matches_numpy(Q):
    """The wrapper's radix plan and twiddle table, run through the kernel's
    index schedule in numpy, give np.fft.fft along axis 0."""
    plan = TP.radix_plan(Q)
    assert np.prod(plan) == Q and all(r in (2, 4, 8, 16) for r in plan)
    assert plan[:-1] == [16] * (len(plan) - 1)
    table = TP.twiddle_table(Q)
    assert table.dtype == np.complex64 and table.shape == (Q,)
    rng = np.random.default_rng(Q)
    x = (rng.standard_normal((Q, 3))
         + 1j * rng.standard_normal((Q, 3))).astype(np.complex64)
    got = _stockham_schedule(x, plan, table)
    want = np.fft.fft(x.astype(np.complex128), axis=0)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1] + _ALL_Q)
def test_fft_cols_kernel_matches_plain_on_card(Q):
    """Every Q the kernel takes, at a P that is no multiple of any tile
    (8, 16 or 128 columns), so the last tile is ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P = _RAGGED_P
    rng = np.random.default_rng(Q + P)
    x = (rng.standard_normal((Q, P))
         + 1j * rng.standard_normal((Q, P))).astype(np.complex64)
    xr = torch.as_tensor(np.ascontiguousarray(x.real), device="cuda")
    xi = torch.as_tensor(np.ascontiguousarray(x.imag), device="cuda")
    before = TP.launches
    yr, yi = TP.make_fft_cols(Q, P, P)(xr, xi)
    pr, pi = TP.fft_cols_plain(xr, xi)
    torch.cuda.synchronize()
    assert TP.launches == before + 1
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    want = np.fft.fft(x.astype(np.complex128), axis=0)
    plain = pr.cpu().numpy() + 1j * pi.cpu().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    assert np.abs(got - plain).max() / np.abs(plain).max() < 2e-6
