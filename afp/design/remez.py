"""First-party Parks–McClellan (Remez exchange) FIR design.

The reference *intends* to offer a Remez path (`design_fir_filter(method=
'remez')`, `reference/filter_methods.py:77-96`) but calls an unimported
``remez`` symbol — a latent NameError.  This module provides a working
implementation of the McClellan–Parks–Rabiner algorithm (1973) for linear-
phase type-I/II filters, on the same dense-grid construction scipy uses
(``grid_density=16``), so results converge to the same unique minimax optimum
(golden-diffed against ``scipy.signal.remez`` in ``tests/test_remez.py``).

Host-side float64 numpy — this is the cold design path.
"""
from __future__ import annotations

import numpy as np

__all__ = ["remez", "RemezError"]


class RemezError(RuntimeError):
    """Raised when the exchange iteration fails to converge."""


def _build_grid(edges: np.ndarray, desired: np.ndarray, weight: np.ndarray,
                nfcns: int, grid_density: int):
    """Dense frequency grid over the union of bands (classic construction).

    `edges` are normalized band edges in [0, 0.5], flat array of 2·nbands.
    Returns (grid, des, wt) arrays plus per-band segment boundaries.
    """
    delf = 0.5 / (grid_density * nfcns)
    grid_parts, des_parts, wt_parts, seg_bounds = [], [], [], []
    pos = 0
    nbands = len(desired)
    for b in range(nbands):
        flow, fup = edges[2 * b], edges[2 * b + 1]
        # classic do/while: add flow, flow+delf, ... while <= fup, then clamp
        # the last added point to exactly fup.
        npts = max(1, int(np.floor((fup - flow) / delf)) + 1)
        pts = flow + delf * np.arange(npts, dtype=np.float64)
        pts[-1] = fup
        if npts > 1 and pts[-1] <= pts[-2]:
            pts = pts[:-1]
            npts -= 1
        grid_parts.append(pts)
        des_parts.append(np.full(npts, desired[b]))
        wt_parts.append(np.full(npts, weight[b]))
        seg_bounds.append((pos, pos + npts))
        pos += npts
    return (
        np.concatenate(grid_parts),
        np.concatenate(des_parts),
        np.concatenate(wt_parts),
        seg_bounds,
    )


def _barycentric_coeffs(x: np.ndarray) -> np.ndarray:
    """Barycentric weights 1/prod_{k!=j}(x_j - x_k) for Lagrange interpolation."""
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    # products can over/underflow for large extremal sets; work in logs.
    sign = np.prod(np.sign(diff), axis=1)
    logp = np.sum(np.log(np.abs(diff)), axis=1)
    logp -= np.mean(logp)  # common scale cancels in all barycentric ratios
    return sign * np.exp(-logp)


def _alternating_extrema(err: np.ndarray, seg_bounds, n_needed: int) -> np.ndarray:
    """Select n_needed alternating extremal indices of the weighted error."""
    cands = []
    for lo, hi in seg_bounds:
        e = err[lo:hi]
        n = hi - lo
        if n == 1:
            cands.append(lo)
            continue
        d = np.diff(e)
        for i in range(n):
            if i == 0 or i == n - 1:
                # band edges are always extremal candidates
                is_ext = True
            else:
                is_ext = (d[i - 1] >= 0 and d[i] <= 0 and e[i] > 0) or (
                    d[i - 1] <= 0 and d[i] >= 0 and e[i] < 0
                )
            if is_ext:
                cands.append(lo + i)
    cands = np.array(sorted(set(cands)), dtype=np.int64)

    # enforce sign alternation: among same-sign runs keep the largest |err|
    keep = []
    for idx in cands:
        if not keep:
            keep.append(idx)
            continue
        if np.sign(err[idx]) == np.sign(err[keep[-1]]):
            if abs(err[idx]) > abs(err[keep[-1]]):
                keep[-1] = idx
        else:
            keep.append(idx)
    keep = list(keep)

    # trim to exactly n_needed, dropping the weaker endpoint(s)
    while len(keep) > n_needed:
        if len(keep) - n_needed >= 2:
            # drop the adjacent pair with the smallest peak to preserve alternation
            pair_max = [max(abs(err[keep[i]]), abs(err[keep[i + 1]])) for i in range(len(keep) - 1)]
            j = int(np.argmin(pair_max))
            del keep[j:j + 2]
        else:
            if abs(err[keep[0]]) < abs(err[keep[-1]]):
                keep.pop(0)
            else:
                keep.pop()
    if len(keep) < n_needed:
        raise RemezError(
            f"found only {len(keep)} alternations, need {n_needed}; "
            "band specification may be degenerate"
        )
    return np.asarray(keep)


def remez(numtaps: int, bands, desired, weight=None, fs: float = 1.0,
          maxiter: int = 250, grid_density: int = 16) -> np.ndarray:
    """Minimax FIR design, call-compatible with ``scipy.signal.remez`` for the
    'bandpass' filter type (the only one the reference uses,
    `reference/filter_methods.py:96`).
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    bands = np.asarray(bands, dtype=np.float64) / fs
    if bands.ndim != 1 or len(bands) % 2:
        raise ValueError("bands must be a flat array of band-edge pairs")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5 + 1e-12:
        raise ValueError("band edges must be nondecreasing within [0, fs/2]")
    desired = np.asarray(desired, dtype=np.float64)
    nbands = len(bands) // 2
    if len(desired) != nbands:
        raise ValueError("desired must have one entry per band")
    if weight is None:
        weight = np.ones(nbands)
    weight = np.asarray(weight, dtype=np.float64)

    nodd = numtaps % 2
    nfcns = numtaps // 2 + (1 if nodd else 0)

    grid, des, wt, seg_bounds = _build_grid(bands, desired, weight, nfcns, grid_density)

    if not nodd:
        # type II: H(f) = cos(pi f) * P(f); optimize P with adjusted des/wt and
        # exclude the cos(pi f)=0 point at Nyquist.
        delf = 0.5 / (grid_density * nfcns)
        if grid[-1] > 0.5 - delf:
            # drop grid points at/too near Nyquist (cos(pi f) -> 0)
            keep_mask = grid <= 0.5 - delf
            # recompute segment bounds under the mask
            new_bounds, pos = [], 0
            for lo, hi in seg_bounds:
                n_seg = int(np.count_nonzero(keep_mask[lo:hi]))
                if n_seg:
                    new_bounds.append((pos, pos + n_seg))
                pos += n_seg
            grid, des, wt = grid[keep_mask], des[keep_mask], wt[keep_mask]
            seg_bounds = new_bounds
        c = np.cos(np.pi * grid)
        des = des / c
        wt = wt * c

    ngrid = len(grid)
    nz = nfcns + 1  # number of extremal frequencies
    if ngrid < nz:
        raise ValueError("frequency grid too coarse for this numtaps; widen bands")

    # initial extremal guess: equally spaced over the grid
    iext = np.round(np.linspace(0, ngrid - 1, nz)).astype(np.int64)

    x_grid = np.cos(2 * np.pi * grid)
    dev = 0.0
    last_dev = -1.0
    for _ in range(maxiter):
        xe = x_grid[iext]
        ad = _barycentric_coeffs(xe)
        alt = np.where(np.arange(nz) % 2 == 0, 1.0, -1.0)
        dev = float(np.dot(ad, des[iext]) / np.dot(alt * ad, 1.0 / wt[iext]))
        ye = des[iext] - alt * dev / wt[iext]

        # interpolated response on the whole grid (barycentric, exact at nodes)
        num = np.zeros(ngrid)
        den = np.zeros(ngrid)
        exact = np.full(ngrid, -1, dtype=np.int64)
        for j in range(nz):
            dx = x_grid - xe[j]
            hit = np.abs(dx) < 1e-14
            exact[hit] = j
            dx[hit] = 1.0
            r = ad[j] / dx
            num += r * ye[j]
            den += r
        A = num / den
        hit_mask = exact >= 0
        if np.any(hit_mask):
            A[hit_mask] = ye[exact[hit_mask]]

        err = (A - des) * wt
        new_iext = _alternating_extrema(err, seg_bounds, nz)

        if np.array_equal(new_iext, iext) or abs(abs(dev) - last_dev) < 1e-14 * max(1.0, abs(dev)):
            iext = new_iext
            break
        last_dev = abs(dev)
        iext = new_iext
    else:
        # exhausted maxiter without the extremal set settling — returning
        # the last iterate would silently miss the minimax ripple; raise
        # like scipy.signal.remez ("failed to converge")
        raise RemezError(
            f"Parks-McClellan exchange failed to converge in {maxiter} "
            "iterations; relax the band spec or raise maxiter")

    # --- final coefficients: sample A(f) on the (2*nfcns-1)-point cosine grid ---
    xe = x_grid[iext]
    ad = _barycentric_coeffs(xe)
    alt = np.where(np.arange(nz) % 2 == 0, 1.0, -1.0)
    dev = float(np.dot(ad, des[iext]) / np.dot(alt * ad, 1.0 / wt[iext]))
    ye = des[iext] - alt * dev / wt[iext]

    cn = 2 * nfcns - 1
    ft = np.arange(nfcns, dtype=np.float64) / cn
    xt = np.cos(2 * np.pi * ft)

    def interp_A(xq: np.ndarray) -> np.ndarray:
        out = np.empty(len(xq))
        for i, xv in enumerate(xq):
            dx = xv - xe
            hit = np.abs(dx) < 1e-14
            if np.any(hit):
                out[i] = ye[np.argmax(hit)]
            else:
                r = ad / dx
                out[i] = np.dot(r, ye) / np.sum(r)
        return out

    Avals = interp_A(xt)

    # inverse cosine series: A(f) = sum_{k=0}^{M-1} alpha_k cos(2*pi*k*f).
    # With s_k = A(0) + 2·Σ_{m=1}^{M-1} A_m cos(2πkm/cn):
    #   alpha_0 = s_0/cn,  alpha_k = 2·s_k/cn (k ≥ 1)
    m = np.arange(nfcns)
    k = np.arange(nfcns)
    cosmat = np.cos(2 * np.pi * np.outer(k, m) / cn)
    s = 2.0 * (cosmat @ Avals) - Avals[0]
    alpha = 2.0 * s / cn
    alpha[0] = s[0] / cn

    h = np.zeros(numtaps)
    if nodd:
        # type I: h[center] = alpha0; h[center±k] = alpha_k/2
        center = nfcns - 1
        h[center] = alpha[0]
        for kk in range(1, nfcns):
            h[center - kk] = alpha[kk] / 2.0
            h[center + kk] = alpha[kk] / 2.0
    else:
        # type II: H(f) = cos(pi f)·P(f); classic half-tap mapping
        # (1-based: h[1]=α[nfcns]/4; h[j]=(α[nz−j]+α[nfcns+2−j])/4; center pair
        #  h[nfcns]=α[1]/2+α[2]/4), then mirror.
        half = np.zeros(nfcns)
        half[0] = 0.25 * alpha[nfcns - 1]
        for j in range(2, nfcns):  # 1-based j in [2, nfcns-1]
            half[j - 1] = 0.25 * (alpha[nfcns - j] + alpha[nfcns + 1 - j])
        half[nfcns - 1] = 0.5 * alpha[0] + 0.25 * alpha[1]
        h[:nfcns] = half
        h[nfcns:] = half[::-1]
    return h
