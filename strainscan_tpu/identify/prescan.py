"""Layer-2 strain detection: iterative Pre-Scan + positive Elastic-Net.

Faithful port of library/identify_strains_L2_Enet_Pscan_new_sp.py:177-478
over dense NumPy matrices (the k-mer × strain matrix is the CSR built at
DB time, densified for the mat-vec loop like the reference's ``X.A``):

* cross-cluster masking: counts of k-mers shared with other detected
  clusters are zeroed via the overlap matrix (``py_u``, :191-205);
* per-strain coverage gate (cov > 0.7 outside plasmid/extra modes,
  :247-261), ``l2=2`` fallback when max coverage < 0.01 (:262-264);
* dominant strain: argmax of X^T·(5-95% clipped y) (optimize_dominat_y,
  :136-175) or max coverage when l2 == 2 (:277-282);
* dominant depth: IQR-trimmed mean of its covered k-mer counts
  (get_avg_depth, :110-120);
* iterative Pre-Scan (<= 15 rounds): mask used k-mers
  (npXt = 2*used + X^T; npXt[npXt>1] = 0, :320-321), candidate = strain
  with most remaining covered k-mers (get_candidate_arr, :121-134), accept
  when covered >= msn*k and stale remain-coverage > 0.2 (:350-371 —
  ``strain_remainc`` is computed once before the loop, and ``used_kmer``
  grows even when the remainc gate rejects the candidate, both
  reproduced);
* Elastic-Net over the selected columns with outlier-filtered rows
  (v <= 1000*median kept, :402-414) and the CV/mpm machinery in
  strainscan_tpu/ops/enet.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.ops import enet
from strainscan_tpu.utils import profiling


def _stat_cov(col: np.ndarray, y: np.ndarray) -> Tuple[float, int, int]:
    """stat_cov (:33-43): coverage counting products > 1 as covered."""
    total = int(np.count_nonzero(col))
    ic = col * y
    valid = int(np.count_nonzero(ic > 1))
    cov = valid / total if total else 0.0
    return cov, valid, total


def _cal_cov_all(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """cal_cov_all (:44-49) vectorized: per-strain coverage."""
    totals = (X != 0).sum(axis=0)
    valid = ((X * y[:, None]) > 1).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = np.where(totals > 0, valid / np.maximum(totals, 1), 0.0)
    return cov


def _optimize_dominant(X: np.ndarray, y: np.ndarray) -> int:
    """optimize_dominat_y (:136-175)."""
    s = X.shape[1]
    res = np.zeros(s)
    for c in range(s):
        da = X[:, c].astype(np.float64) * y
        da_noz = da[da != 0]
        if da_noz.size < 1 or np.sum(da_noz) == 0:
            res[c] = 0.0
            continue
        f25 = np.percentile(da_noz, 5, method="nearest")
        f75 = np.percentile(da_noz, 95, method="nearest")
        tem = y.copy().astype(np.float64)
        tem[tem < f25] = 0
        tem[tem > f75] = 0
        res[c] = float(X[:, c] @ tem)
    return int(np.where(res == res.max())[0][0])


def _avg_depth(dominant: int, X: np.ndarray, y: np.ndarray) -> float:
    """get_avg_depth (:110-120): IQR-trimmed mean of covered counts."""
    doarr = X[:, dominant].astype(np.float64) * y
    doarr = np.where(doarr == 1, 0, doarr)
    noz = doarr[doarr != 0]
    if noz.size == 0:
        return 0.0
    f25 = np.percentile(noz, 25, method="nearest")
    f75 = np.percentile(noz, 75, method="nearest")
    noz = noz.astype(np.float64)
    noz[noz < f25] = 0
    noz[noz > f75] = 0
    final = noz[noz != 0]
    return float(np.mean(final)) if final.size else 0.0


def _candidate(npXt: np.ndarray, y: np.ndarray) -> Tuple[int, int]:
    """get_candidate_arr (:121-134): most remaining covered k-mers."""
    prod = npXt * y[None, :]
    checks = (prod > 1).sum(axis=1)
    cand = int(np.argmax(checks))
    return cand, int(checks[cand])


def _jit_kernels():
    """Module-level jitted colsum/or helpers — created ONCE so repeat
    samples don't re-trace (a fresh closure per _L2Kernels instance
    missed the jit cache every sample)."""
    global _JIT_KERNELS
    if _JIT_KERNELS is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def colsum(Xd, m):
            return jnp.einsum("ns,n->s", Xd, m.astype(jnp.int8),
                              preferred_element_type=jnp.int32)

        @jax.jit
        def colsum_unused(Xd, used, big):
            m = jnp.logical_and(jnp.logical_not(used), big)
            return jnp.einsum("ns,n->s", Xd, m.astype(jnp.int8),
                              preferred_element_type=jnp.int32)

        @jax.jit
        def or_col(used, Xd, c):
            return used | (Xd[:, c] > 0)

        _JIT_KERNELS = (colsum, colsum_unused, or_col)
    return _JIT_KERNELS


_JIT_KERNELS = None


class _L2Kernels:
    """Device-resident Pre-Scan linear algebra (SURVEY §7: 'Pre-Scan as
    jnp mat-vecs').

    Everything the scan loop needs reduces to masked COLUMN SUMS of the
    0/1 k-mer x strain matrix — ``X^T m`` with a boolean row mask — plus
    an O(n) running ``used`` union.  All inputs are 0/1 and counts are
    ints, so int8 matvecs (int32 accumulate) are EXACT and bit-match the
    reference's dense products:

        get_candidate_arr (:121-134): count((npXt * y) > 1) per strain,
          where npXt = pXt_tem masked by ~used  ==  X^T (~used & (y > 1))
        get_remainc (:94-108): same with the pre-loop used vector
        cal_cov_all / stat_cov (:33-49): X^T (y > 1) over X's support

    ``use_device=False`` runs the same integer algebra in NumPy; with
    the device on, a device failure raises.  The scan control flow
    (accept/reject, data-dependent exit — SURVEY hard part #5) stays on
    the host, fetching two scalars per round.
    """

    def __init__(self, X: np.ndarray, use_device: bool = True,
                 min_shard_rows: Optional[int] = None):
        self.n, self.s = X.shape
        if X.size and (X.min() < 0 or X.max() > 1
                       or not np.array_equal(X, np.rint(X))):
            raise ValueError("Pre-Scan kernels require a 0/1 strain matrix")
        X8 = X.astype(np.int8)
        self.jax = None
        self.mesh = None
        self._pad = 0
        if use_device:
            import jax
            import jax.numpy as jnp

            self.jax = jax
            if min_shard_rows is not None:
                from strainscan_tpu.parallel import sharded as psh

                self.mesh = psh.l2_mesh(self.n, min_shard_rows)
            if self.mesh is not None:
                # k-mer axis sharded over the whole mesh: every colsum
                # below reduces with ONE psum and returns the O(s) vector
                # replicated (ref workload anchor
                # identify_strains_L2_Enet_Pscan_new_sp.py:431-456)
                npad = psh.pad_rows(self.mesh, self.n)
                self._pad = npad - self.n
                if self._pad:
                    X8p = np.zeros((npad, self.s), np.int8)
                    X8p[: self.n] = X8
                else:
                    X8p = X8
                self.Xd = psh.shard_rows(self.mesh, X8p)
                self._colsum_sh = psh.sharded_colsum_fn(self.mesh)
                self._colsum_unused_sh = \
                    psh.sharded_colsum_unused_fn(self.mesh)
                self._or_col_sh = psh.sharded_or_col_fn(self.mesh)
            else:
                self.Xd = jnp.asarray(X8)

            (self._colsum, self._colsum_unused,
             self._or_col) = _jit_kernels()
        if self.jax is None:
            self.X8 = X8

    def to_mask(self, m: np.ndarray):
        if self.mesh is not None:
            from strainscan_tpu.parallel import sharded as psh

            m = np.asarray(m)
            if self._pad:
                mp = np.zeros(self.n + self._pad, dtype=m.dtype)
                mp[: self.n] = m
                m = mp
            return psh.shard_rows(self.mesh, m)
        if self.jax is not None:
            import jax.numpy as jnp

            return jnp.asarray(m)
        return np.asarray(m)

    def colsum(self, mask) -> np.ndarray:
        """int32 [s]: per-strain count of set rows within X's support."""
        if self.mesh is not None:
            return np.asarray(self._colsum_sh(self.Xd, mask))
        if self.jax is not None:
            return np.asarray(self._colsum(self.Xd, mask))
        return self.X8.T.astype(np.int32) @ mask.astype(np.int32)

    def colsum_unused(self, used, big) -> np.ndarray:
        """int32 [s]: X^T (~used & big) — one fused matvec per round."""
        if self.mesh is not None:
            return np.asarray(self._colsum_unused_sh(self.Xd, used, big))
        if self.jax is not None:
            return np.asarray(self._colsum_unused(self.Xd, used, big))
        return self.X8.T.astype(np.int32) @ (
            (~used) & big).astype(np.int32)

    def or_column(self, used, c: int):
        """used |= X[:, c] (kept device-resident across scan rounds)."""
        if self.mesh is not None:
            return self._or_col_sh(used, self.Xd, c)
        if self.jax is not None:
            return self._or_col(used, self.Xd, c)
        return used | (self.X8[:, c] > 0)


def detect_strains(
    X: np.ndarray,
    py: np.ndarray,
    sid: List[str],
    ksize: int,
    npp25: float,
    npp75: float,
    npp_out: float,
    cls_cov: float,
    om_selected: np.ndarray,
    l2: int,
    msn: int,
    pmode: int,
    emode: int,
    cfg: IdentifyConfig = IdentifyConfig(),
):
    """detect_strains (:177-478).

    Args mirror the reference: X is the dense k-mer × strain matrix, py the
    per-k-mer counts (1-counts already zeroed), om_selected the overlap
    matrix restricted to the detected clusters' columns.
    """
    # X stays int8 end to end (it is tens-of-MB x 8 at E. coli scale as
    # float64); column products cast on demand
    X = np.asarray(X)
    py = np.asarray(py, dtype=np.float64)
    ln = om_selected.sum(axis=1).astype(np.float64)
    ln[ln > 1] = 0
    py_u = py * ln

    cutoff = msn * ksize
    # X is the 0/1 strain matrix (all_strains_re), so every Pre-Scan
    # statistic reduces to exact integer matvecs (see _L2Kernels); the
    # [s, n] npXt materialization per round is gone.
    kern = _L2Kernels(X, min_shard_rows=cfg.shard_min_l2_rows)
    totals = kern.colsum(kern.to_mask(np.ones(X.shape[0], dtype=bool)))
    big_py = py > 1
    valid_all = kern.colsum(kern.to_mask(big_py))
    with np.errstate(divide="ignore", invalid="ignore"):
        cov_arr = np.where(totals > 0, valid_all / np.maximum(totals, 1),
                           0.0)

    def stat_cov_i(i):
        t = int(totals[i])
        v = int(valid_all[i])
        return (v / t if t else 0.0, v, t)

    dominant_avg_depth = 0.0
    default_cov = 0.0 if (pmode == 1 or emode == 1) else cfg.prescan_default_cov
    # gate_float mirrors the reference's dtype flow: when the coverage
    # gate applies, pXt_tem = pXt * float mask makes the candidate
    # ``check`` a float (printed "8674.0" in StrainVote.report); in the
    # ungated else branch it stays int (identify_strains...sp.py:256-262,
    # get_candidate_arr :121-134)
    gate_float = bool(np.max(cov_arr) > default_cov)
    if gate_float:
        gate = (cov_arr > default_cov).astype(np.float64)
    else:
        gate = np.ones(X.shape[1])
        if np.max(cov_arr) < 0.01:
            l2 = 2

    if l2 == 2:
        dominant = int(np.where(cov_arr == cov_arr.max())[0][0])
        dominant_avg_depth = _avg_depth(
            dominant, X, py_u if py_u.sum() > 0 else py)
    else:
        yy = py_u if py_u.sum() > 0 else py
        with profiling.phase_acc("l2/optimize_dominant"):
            dominant = _optimize_dominant(X, yy)
        dominant_avg_depth = _avg_depth(dominant, X, yy)

    out_columns = [dominant]
    out_strains = [sid[dominant]]
    strain_cov: Dict[str, Tuple[float, int, int]] = {}
    strain_val: Dict[str, int] = {}
    final_src: Dict[str, float] = {}
    strain_cov[sid[dominant]] = stat_cov_i(dominant)
    strain_val[sid[dominant]] = strain_cov[sid[dominant]][1]
    final_src[sid[dominant]] = strain_cov[sid[dominant]][0]

    # stale remain-coverage, computed once (get_remainc, :94-108 at :316):
    # npXt0[i] = pXt_tem[i] & ~used, so all_k = gate * X^T(~used) and the
    # covered count = gate * X^T(~used & (py_u > 1))
    used = kern.to_mask(X[:, dominant] > 0)
    big_pyu = kern.to_mask(big_py & (ln > 0))
    all_ones = kern.to_mask(np.ones(X.shape[0], dtype=bool))
    all_k = gate * kern.colsum_unused(used, all_ones)
    chk = gate * kern.colsum_unused(used, big_pyu)
    with np.errstate(divide="ignore", invalid="ignore"):
        strain_remainc = np.where(all_k > 0, chk / np.maximum(all_k, 1), 0.0)
    strain_remainc[dominant] = strain_cov[sid[dominant]][0]

    big_yy = big_pyu if py_u.sum() > 0 else kern.to_mask(big_py)
    remainc_cutoff = 0.0 if emode == 1 else cfg.prescan_remainc
    check_c = cfg.emode_check_c if emode == 1 else cutoff
    for _ in range(cfg.prescan_max_iter):
        # get_candidate_arr (:121-134): one fused matvec per round
        checks = gate * kern.colsum_unused(used, big_yy)
        cand = int(np.argmax(checks))
        check = int(checks[cand])
        if check >= check_c:
            if strain_remainc[cand] > remainc_cutoff:
                out_columns.append(cand)
                out_strains.append(sid[cand])
                strain_cov[sid[cand]] = stat_cov_i(cand)
                strain_val[sid[cand]] = float(check) if gate_float else check
                final_src[sid[cand]] = strain_remainc[cand]
            used = kern.or_column(used, cand)
        else:
            break

    if len(out_columns) == 1:
        res = {out_strains[0]: 1}
        res2 = {out_strains[0]: dominant_avg_depth}
        return res, res2, strain_cov, strain_val, final_src

    # -------------------- Elastic-Net over selected columns (:399-456)
    oX = X[:, out_columns]
    keep = ~((py < npp25) | (py > npp75) | (py > npp_out))
    Xf = oX[keep]
    yf = py[keep]
    with profiling.phase_acc("l2/enet_cv_fit"):
        result = enet.enet_cv_fit(Xf, yf, cfg)
    coef = np.atleast_1d(result.coef)
    if coef.sum() != 0:
        norm = coef / coef.sum()
        res = dict(zip(out_strains, norm.tolist()))
        res2 = dict(zip(out_strains, coef.tolist()))
    else:
        res, res2 = {}, {}
    return res, res2, strain_cov, strain_val, final_src
