"""NumPy/SciPy copies of the scikit-learn 1.9.0 estimators that the tools
use (``tools/graph_kernels.py``, ``tools/active_learning.py``): the GPU
machine has no scikit-learn, and ``kgcn_tpu``'s tools import it.

* ``SVC``: C-support vector classification, kernels ``"precomputed"`` and
  ``"rbf"`` (``gamma`` ``"scale"``, ``"auto"`` or a number).  The solver is
  libsvm's (``sklearn/svm/src/libsvm/svm.cpp``) copied step for step in
  float64: ``Solver::Solve`` with the second-order working-set selection
  (``select_working_set``), shrinking every ``min(l, 1000)`` iterations,
  the gradient reconstruction and ``calculate_rho``, over a ``Q`` stored
  as float32 (libsvm's ``Qfloat``); the classes sorted and grouped as
  ``svm_group_classes`` does, one-vs-one for more than two, the support
  vectors and their coefficients laid out as ``svm_train`` lays them.
  ``probability=True`` fits Platt's sigmoid per pair as
  ``svm_binary_svc_probability`` does: 5 internal folds over a shuffle
  drawn with ``bounded_rand_int`` (the tweaked Lemire bound of
  ``newrand.h``) from an MT19937 that every ``svm_train`` call seeds again
  with ``set_seed(seed)``, the seed being ``RandomState(random_state)
  .randint(2**31 - 1)`` (``_base.py:292``); then ``sigmoid_train`` and,
  per sample, ``multiclass_probability``.  NumPy's
  ``MT19937._legacy_seeding(seed)`` is ``std::mt19937::seed(seed)``.
  ``decision_function`` is libsvm's per pair (sign flipped for two
  classes, as scikit-learn flips it), and with more than two classes
  scikit-learn's ``_ovr_decision_function``.
* ``KernelRidge`` (precomputed): ``_solve_cholesky_kernel``'s solve,
  ``scipy.linalg.solve(K + αI, y, assume_a="pos")``.
* ``LabelPropagation`` and ``LabelSpreading`` with the rbf kernel
  (``gamma=20``; ``max_iter`` 1000 and 30, ``tol`` 1e-3, ``alpha`` 0.2 for
  spreading): ``rbf_kernel`` and the propagation loop as scikit-learn
  writes them.

The rbf kernel's inner products are BLAS ``ddot`` calls per pair, as in
libsvm (a matrix product sums in another order, and a last-bit change
before the float32 rounding of ``Q`` can move the solver's path); its
``exp``, and the logistic fit's ``exp`` and ``log``, are the C library's
(NumPy's ``exp`` may differ in the last bit).  Precomputed kernels take
every value as given.
"""
from __future__ import annotations

import math

import numpy as np

_TAU = 1e-12
_EPS = 1e-3  # the stopping tolerance (scikit-learn's tol); shrinking is always on
_INF = math.inf
_LOWER, _UPPER, _FREE = 0, 1, 2


# ---------------------------------------------------------------------------
# libsvm's random numbers (newrand.h)


class _MT:
    """``std::mt19937`` as ``newrand.h`` drives it: ``seed(s)`` and
    ``bounded_rand_int(range)``."""

    def __init__(self):
        self.seed(5489)  # std::mt19937::default_seed

    def seed(self, s: int) -> None:
        self._bg = np.random.MT19937(0)
        self._bg._legacy_seeding(int(s) & 0xFFFFFFFF)

    def _next(self) -> int:
        return int(self._bg.random_raw())

    def bounded_rand_int(self, rng: int) -> int:
        """The tweaked Lemire post-processor of ``newrand.h``."""
        rng &= 0xFFFFFFFF
        x = self._next()
        m = x * rng
        low = m & 0xFFFFFFFF
        if low < rng:
            t = (-rng) & 0xFFFFFFFF
            if t >= rng:
                t -= rng
                if t >= rng:
                    t %= rng
            while low < t:
                x = self._next()
                m = x * rng
                low = m & 0xFFFFFFFF
        return m >> 32


# ---------------------------------------------------------------------------
# libsvm's C-SVC solver


class _Solver:
    """``Solver::Solve`` of libsvm for C-SVC (``p = -1``, ``alpha = 0`` at
    the start), on the float32 ``Q`` of one sub-problem.  The arrays are
    kept in libsvm's active-set order: ``swap`` moves rows and columns of
    ``Q`` as ``SVC_Q::swap_index`` moves its kernel rows."""

    def __init__(self, K, y, C):
        l = len(y)
        self.l = l
        self.y = np.asarray(y, np.int64).copy()
        yy = self.y.astype(np.float64)
        # Qfloat: y_i·y_j·K(i,j) rounded to float32; QD in float64
        self.Q = (yy[:, None] * yy[None, :] * K).astype(np.float32).astype(np.float64)
        self.QD = np.array(np.diagonal(K), np.float64)
        self.C = np.asarray(C, np.float64).copy()
        self.p = np.full(l, -1.0)
        self.alpha = np.zeros(l)
        self.eps = _EPS
        self.status = np.zeros(l, np.int8)
        for i in range(l):
            self._update_status(i)
        self.active_set = np.arange(l)
        self.active_size = l
        self.G = self.p.copy()
        self.G_bar = np.zeros(l)
        self.unshrink = False

    def _update_status(self, i):
        if self.alpha[i] >= self.C[i]:
            self.status[i] = _UPPER
        elif self.alpha[i] <= 0:
            self.status[i] = _LOWER
        else:
            self.status[i] = _FREE

    def swap(self, i, j):
        if i == j:
            return
        for a in (self.y, self.G, self.status, self.alpha, self.p, self.active_set,
                  self.G_bar, self.C, self.QD):
            a[i], a[j] = a[j], a[i]
        self.Q[[i, j], :] = self.Q[[j, i], :]
        self.Q[:, [i, j]] = self.Q[:, [j, i]]

    def reconstruct_gradient(self):
        a, l = self.active_size, self.l
        if a == l:
            return
        self.G[a:] = self.G_bar[a:] + self.p[a:]
        free = np.nonzero(self.status[:a] == _FREE)[0]
        nr_free = len(free)
        if nr_free * l > 2 * a * (l - a):
            # per inactive i, over the free j of its row, in order
            for i in range(a, l):
                g = self.G[i]
                q = self.Q[i]
                for j in free:
                    g += self.alpha[j] * q[j]
                self.G[i] = g
        else:
            for i in free:
                self.G[a:] += self.alpha[i] * self.Q[i, a:]

    def select_working_set(self):
        """(i, j), or None where the solution is optimal."""
        a = self.active_size
        y, G, st = self.y[:a], self.G[:a], self.status[:a]
        pos = y == 1
        up_ok = np.where(pos, st != _UPPER, st != _LOWER)
        v = np.where(pos, -G, G)
        Gmax, i = -_INF, -1
        if up_ok.any():
            cand = np.nonzero(up_ok)[0]
            vals = v[cand]
            Gmax = float(vals.max())
            i = int(cand[np.nonzero(vals == Gmax)[0][-1]])
        low_ok = np.where(pos, st != _LOWER, st != _UPPER)
        w = np.where(pos, G, -G)
        Gmax2 = float(w[low_ok].max()) if low_ok.any() else -_INF
        j = -1
        if i != -1:
            grad_diff = Gmax + w  # Gmax + G (y=+1), Gmax - G (y=-1)
            ok = low_ok & (grad_diff > 0)
            if ok.any():
                cand = np.nonzero(ok)[0]
                gd = grad_diff[cand]
                qi = self.Q[i, cand]
                yi = float(self.y[i])
                quad = np.where(pos[cand], self.QD[i] + self.QD[cand] - (2.0 * yi) * qi,
                                self.QD[i] + self.QD[cand] + (2.0 * yi) * qi)
                obj = np.where(quad > 0, -(gd * gd) / np.where(quad > 0, quad, 1.0),
                               -(gd * gd) / _TAU)
                m = obj.min()
                j = int(cand[np.nonzero(obj == m)[0][-1]])
        if Gmax + Gmax2 < self.eps or j == -1:
            return None
        return i, j

    def _be_shrunk(self, i, Gmax1, Gmax2):
        s, y, g = self.status[i], self.y[i], self.G[i]
        if s == _UPPER:
            return -g > (Gmax1 if y == 1 else Gmax2)
        if s == _LOWER:
            return g > (Gmax2 if y == 1 else Gmax1)
        return False

    def do_shrinking(self):
        a = self.active_size
        y, G, st = self.y[:a], self.G[:a], self.status[:a]
        pos = y == 1
        g1 = np.concatenate([-G[pos & (st != _UPPER)], G[~pos & (st != _LOWER)]])
        g2 = np.concatenate([G[pos & (st != _LOWER)], -G[~pos & (st != _UPPER)]])
        Gmax1 = float(g1.max()) if len(g1) else -_INF
        Gmax2 = float(g2.max()) if len(g2) else -_INF
        if not self.unshrink and Gmax1 + Gmax2 <= self.eps * 10:
            self.unshrink = True
            self.reconstruct_gradient()
            self.active_size = self.l
        i = 0
        while i < self.active_size:
            if self._be_shrunk(i, Gmax1, Gmax2):
                self.active_size -= 1
                while self.active_size > i:
                    if not self._be_shrunk(self.active_size, Gmax1, Gmax2):
                        self.swap(i, self.active_size)
                        break
                    self.active_size -= 1
            i += 1

    def calculate_rho(self):
        a = self.active_size
        yG = self.y[:a] * self.G[:a]
        st, y = self.status[:a], self.y[:a]
        ub_mask = ((st == _UPPER) & (y == -1)) | ((st == _LOWER) & (y == 1))
        lb_mask = ((st == _UPPER) & (y == 1)) | ((st == _LOWER) & (y == -1))
        free = st == _FREE
        if free.any():
            return float(np.cumsum(yG[free])[-1]) / int(free.sum())
        ub = float(yG[ub_mask].min()) if ub_mask.any() else _INF
        lb = float(yG[lb_mask].max()) if lb_mask.any() else -_INF
        return (ub + lb) / 2

    def solve(self):
        """→ (alpha in the caller's order, rho, iterations)."""
        l = self.l
        it = 0
        counter = min(l, 1000) + 1
        while True:  # scikit-learn's max_iter -1: no limit
            counter -= 1
            if counter == 0:
                counter = min(l, 1000)
                self.do_shrinking()
            ws = self.select_working_set()
            if ws is None:
                self.reconstruct_gradient()
                self.active_size = l
                ws = self.select_working_set()
                if ws is None:
                    break
                counter = 1  # do shrinking next iteration
            it += 1
            i, j = ws
            self._step(i, j)
        rho = self.calculate_rho()
        alpha = np.empty(l)
        alpha[self.active_set] = self.alpha
        return alpha, rho, it

    def _step(self, i, j):
        a, l = self.active_size, self.l
        Q_i, Q_j = self.Q[i], self.Q[j]
        C_i, C_j = float(self.C[i]), float(self.C[j])
        al = self.alpha
        old_i, old_j = float(al[i]), float(al[j])
        ai, aj = old_i, old_j
        G = self.G
        if self.y[i] != self.y[j]:
            quad = float(self.QD[i]) + float(self.QD[j]) + 2 * float(Q_i[j])
            if quad <= 0:
                quad = _TAU
            delta = (-float(G[i]) - float(G[j])) / quad
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj = 0.0
                    ai = diff
            else:
                if ai < 0:
                    ai = 0.0
                    aj = -diff
            if diff > C_i - C_j:
                if ai > C_i:
                    ai = C_i
                    aj = C_i - diff
            else:
                if aj > C_j:
                    aj = C_j
                    ai = C_j + diff
        else:
            quad = float(self.QD[i]) + float(self.QD[j]) - 2 * float(Q_i[j])
            if quad <= 0:
                quad = _TAU
            delta = (float(G[i]) - float(G[j])) / quad
            s = ai + aj
            ai -= delta
            aj += delta
            if s > C_i:
                if ai > C_i:
                    ai = C_i
                    aj = s - C_i
            else:
                if aj < 0:
                    aj = 0.0
                    ai = s
            if s > C_j:
                if aj > C_j:
                    aj = C_j
                    ai = s - C_j
            else:
                if ai < 0:
                    ai = 0.0
                    aj = s
        al[i], al[j] = ai, aj
        dai, daj = ai - old_i, aj - old_j
        G[:a] += Q_i[:a] * dai + Q_j[:a] * daj
        ui, uj = self.status[i] == _UPPER, self.status[j] == _UPPER
        self._update_status(i)
        self._update_status(j)
        if ui != (self.status[i] == _UPPER):
            if ui:
                self.G_bar -= C_i * Q_i[:l]
            else:
                self.G_bar += C_i * Q_i[:l]
        if uj != (self.status[j] == _UPPER):
            if uj:
                self.G_bar -= C_j * Q_j[:l]
            else:
                self.G_bar += C_j * Q_j[:l]


# ---------------------------------------------------------------------------
# libsvm's training and prediction over sample indices


class _Kernel:
    """Kernel values between samples by index: ``precomputed`` reads the
    matrix (row: the first sample, column: the second, as
    ``kernel_precomputed`` reads ``x[i].values[x[j].ind]``); ``rbf``
    computes ``kernel_rbf``'s ``exp(-γ(|x_i|² + |x_j|² - 2⟨x_i, x_j⟩))``
    and, for prediction, ``k_function``'s ``exp(-γ|x - sv|²)``, each inner
    product one BLAS ``ddot`` as libsvm takes it (SciPy's, the BLAS
    scikit-learn hands libsvm), so the sums run in libsvm's order."""

    def __init__(self, kind, X, gamma):
        self.kind, self.X, self.gamma = kind, X, gamma
        self._full = None

    def _gram(self):
        if self._full is None:
            from scipy.linalg.blas import ddot

            X = self.X
            n = len(X)
            sq = np.array([ddot(x, x) for x in X])
            dot = np.empty((n, n))
            for a in range(n):
                for b in range(a, n):
                    dot[a, b] = dot[b, a] = ddot(X[a], X[b])
            self._full = np.exp(-self.gamma * (sq[:, None] + sq[None, :] - 2 * dot))
        return self._full

    def train(self, idx):
        full = self.X if self.kind == "precomputed" else self._gram()
        return full[np.ix_(idx, idx)]

    def predict(self, T, sv_idx):
        """``k_function(x, SV)`` for test rows ``T`` against the support
        vectors (training indices ``sv_idx``)."""
        if self.kind == "precomputed":
            return np.asarray(T, np.float64)[:, sv_idx]
        from scipy.linalg.blas import ddot

        S = self.X[sv_idx]
        d2 = np.empty((len(T), len(S)))
        for t, x in enumerate(T):
            diff = x[None, :] - S
            for k in range(len(S)):
                d2[t, k] = ddot(diff[k], diff[k])
        return np.exp(-self.gamma * d2)


class _Model:
    """An ``svm_model`` of C-SVC: labels (sorted), rho, probA/B, nSV, the
    support vectors' training indices (``sv_ind``) and ``sv_coef``
    (attributes set by ``_svm_train``)."""


def _group_classes(y):
    """``svm_group_classes``: labels sorted, each class's samples in their
    order → (labels, start, count, perm)."""
    labels = sorted(set(int(v) for v in y))
    data_label = np.array([labels.index(int(v)) for v in y], np.int64)
    count = np.bincount(data_label, minlength=len(labels))
    start = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    perm = np.argsort(data_label, kind="stable")
    return labels, start, count, perm


def _train_one(kern, idx, ysub, Cp, Cn):
    """``svm_train_one`` of C-SVC over the samples ``idx`` with labels ±1."""
    C = np.where(ysub > 0, Cp, Cn).astype(np.float64)
    alpha, rho, _ = _Solver(kern.train(idx), ysub, C).solve()
    return alpha * ysub, rho


def _sigmoid_train(dec, labels):
    """``sigmoid_train``: Platt's fit with Lin et al.'s Newton steps."""
    l = len(dec)
    prior1 = float(sum(1 for v in labels if v > 0))
    prior0 = float(l - prior1)
    max_iter, min_step, sigma, eps = 100, 1e-10, 1e-12, 1e-5
    hi, lo = (prior1 + 1.0) / (prior1 + 2.0), 1 / (prior0 + 2.0)
    t = [hi if v > 0 else lo for v in labels]
    dec = [float(d) for d in dec]
    A, B = 0.0, math.log((prior0 + 1.0) / (prior1 + 1.0))

    def fval_of(A, B):
        f = 0.0
        for d, ti in zip(dec, t):
            fApB = d * A + B
            if fApB >= 0:
                f += ti * fApB + math.log(1 + math.exp(-fApB))
            else:
                f += (ti - 1) * fApB + math.log(1 + math.exp(fApB))
        return f

    fval = fval_of(A, B)
    for _ in range(max_iter):
        h11, h22, h21, g1, g2 = sigma, sigma, 0.0, 0.0, 0.0
        for d, ti in zip(dec, t):
            fApB = d * A + B
            if fApB >= 0:
                p = math.exp(-fApB) / (1.0 + math.exp(-fApB))
                q = 1.0 / (1.0 + math.exp(-fApB))
            else:
                p = 1.0 / (1.0 + math.exp(fApB))
                q = math.exp(fApB) / (1.0 + math.exp(fApB))
            d2 = p * q
            h11 += d * d * d2
            h22 += d2
            h21 += d * d2
            d1 = ti - p
            g1 += d * d1
            g2 += d1
        if abs(g1) < eps and abs(g2) < eps:
            break
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        stepsize = 1.0
        while stepsize >= min_step:
            newA, newB = A + stepsize * dA, B + stepsize * dB
            newf = fval_of(newA, newB)
            if newf < fval + 0.0001 * stepsize * gd:
                A, B, fval = newA, newB, newf
                break
            stepsize = stepsize / 2.0
        if stepsize < min_step:
            break
    return A, B


def _sigmoid_predict(dec, A, B):
    fApB = dec * A + B
    if fApB >= 0:
        return math.exp(-fApB) / (1.0 + math.exp(-fApB))
    return 1.0 / (1 + math.exp(fApB))


def _multiclass_probability(k, r):
    """Method 2 of Wu, Lin and Weng (``multiclass_probability``)."""
    max_iter, eps = max(100, k), 0.005 / k
    p = [1.0 / k] * k
    Q = [[0.0] * k for _ in range(k)]
    for t in range(k):
        for j in range(t):
            Q[t][t] += r[j][t] * r[j][t]
            Q[t][j] = Q[j][t]
        for j in range(t + 1, k):
            Q[t][t] += r[j][t] * r[j][t]
            Q[t][j] = -r[j][t] * r[t][j]
    Qp = [0.0] * k
    for _ in range(max_iter):
        pQp = 0.0
        for t in range(k):
            Qp[t] = 0.0
            for j in range(k):
                Qp[t] += Q[t][j] * p[j]
            pQp += p[t] * Qp[t]
        max_error = 0.0
        for t in range(k):
            error = abs(Qp[t] - pQp)
            if error > max_error:
                max_error = error
        if max_error < eps:
            break
        for t in range(k):
            diff = (-Qp[t] + pQp) / Q[t][t]
            p[t] += diff
            pQp = (pQp + diff * (diff * Q[t][t] + 2 * Qp[t])) / (1 + diff) / (1 + diff)
            for j in range(k):
                Qp[j] = (Qp[j] + diff * Q[t][j]) / (1 + diff)
                p[j] /= (1 + diff)
    return p


def _decision_values(model, kvalue):
    """``svm_predict_values``' pairwise values for kernel rows ``kvalue``
    ``[n, total_sv]`` → ``[n, k(k-1)/2]``, each a sum in libsvm's order."""
    k = len(model.labels)
    start = np.concatenate([[0], np.cumsum(model.nSV)[:-1]]).astype(np.int64)
    out = np.empty((kvalue.shape[0], k * (k - 1) // 2))
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            si, sj, ci, cj = start[i], start[j], model.nSV[i], model.nSV[j]
            terms = np.concatenate(
                [model.sv_coef[j - 1][si:si + ci] * kvalue[:, si:si + ci],
                 model.sv_coef[i][sj:sj + cj] * kvalue[:, sj:sj + cj]], axis=1)
            s = np.cumsum(terms, axis=1)[:, -1] if terms.shape[1] else np.zeros(len(kvalue))
            out[:, p] = s - model.rho[p]
            p += 1
    return out


def _vote(model, dec):
    """libsvm's vote per sample → label index."""
    k = len(model.labels)
    out = np.empty(len(dec), np.int64)
    for n in range(len(dec)):
        vote = [0] * k
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                if dec[n, p] > 0:
                    vote[i] += 1
                else:
                    vote[j] += 1
                p += 1
        best = 0
        for i in range(1, k):
            if vote[i] > vote[best]:
                best = i
        out[n] = best
    return out


def _svm_train(kern, idx, y, C, weights, probability, seed, mt):
    """``svm_train`` of C-SVC over samples ``idx`` (training indices) with
    integer labels ``y``; ``weights``: {label: factor of C}."""
    model = _Model()
    if seed >= 0:
        mt.seed(seed)
    labels, start, count, perm = _group_classes(y)
    k = len(labels)
    xs, ys = np.asarray(idx)[perm], np.asarray(y)[perm]
    wC = np.array([C * weights.get(lab, 1.0) for lab in labels])
    nonzero = np.zeros(len(xs), bool)
    fs, probA, probB = [], [], []
    for i in range(k):
        for j in range(i + 1, k):
            si, sj, ci, cj = start[i], start[j], count[i], count[j]
            sub = np.concatenate([xs[si:si + ci], xs[sj:sj + cj]])
            ysub = np.concatenate([np.ones(ci, np.int64), -np.ones(cj, np.int64)])
            if probability:
                a, b = _binary_probability(kern, sub, ysub, wC[i], wC[j], seed, mt)
                probA.append(a)
                probB.append(b)
            alpha, rho = _train_one(kern, sub, ysub, wC[i], wC[j])
            nonzero[si:si + ci] |= np.abs(alpha[:ci]) > 0
            nonzero[sj:sj + cj] |= np.abs(alpha[ci:]) > 0
            fs.append((alpha, rho))
    model.labels = labels
    model.rho = np.array([f[1] for f in fs])
    model.probA = np.array(probA) if probability else None
    model.probB = np.array(probB) if probability else None
    model.nSV = np.array([int(nonzero[start[i]:start[i] + count[i]].sum())
                          for i in range(k)], np.int64)
    model.sv_pos = np.nonzero(nonzero)[0]           # positions in the grouped order
    model.sv_ind = xs[model.sv_pos]                 # training indices
    nz_start = np.concatenate([[0], np.cumsum(model.nSV)[:-1]]).astype(np.int64)
    total = int(model.nSV.sum())
    model.sv_coef = np.zeros((max(k - 1, 1), total))
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            alpha = fs[p][0]
            si, sj, ci, cj = start[i], start[j], count[i], count[j]
            q = nz_start[i]
            for kk in range(ci):
                if nonzero[si + kk]:
                    model.sv_coef[j - 1][q] = alpha[kk]
                    q += 1
            q = nz_start[j]
            for kk in range(cj):
                if nonzero[sj + kk]:
                    model.sv_coef[i][q] = alpha[ci + kk]
                    q += 1
            p += 1
    return model


def _binary_probability(kern, sub, ysub, Cp, Cn, seed, mt):
    """``svm_binary_svc_probability``: decision values of 5 internal folds
    over a shuffle of ``mt``, then ``sigmoid_train``."""
    l = len(sub)
    nr_fold = 5
    perm = list(range(l))
    for i in range(l):
        j = i + mt.bounded_rand_int(l - i)
        perm[i], perm[j] = perm[j], perm[i]
    perm = np.asarray(perm, np.int64)
    dec = np.zeros(l)
    for i in range(nr_fold):
        begin, end = i * l // nr_fold, (i + 1) * l // nr_fold
        tr = np.concatenate([perm[:begin], perm[end:]])
        te = perm[begin:end]
        yt = ysub[tr]
        pc, nc = int((yt > 0).sum()), int((yt <= 0).sum())
        if pc == 0 and nc == 0:
            dec[te] = 0
        elif pc > 0 and nc == 0:
            dec[te] = 1
        elif pc == 0 and nc > 0:
            dec[te] = -1
        else:
            m = _svm_train(kern, sub[tr], yt, 1.0, {1: Cp, -1: Cn}, False, seed, mt)
            kv = kern.predict(kern.X[sub[te]], m.sv_ind)
            dec[te] = _decision_values(m, kv)[:, 0] * m.labels[0]
    return _sigmoid_train(dec, ysub)


def _seed_of(random_state) -> int:
    """The libsvm seed scikit-learn draws (``_base.py:292``)."""
    if random_state is None:
        rnd = np.random.mtrand._rand
    elif isinstance(random_state, np.random.RandomState):
        rnd = random_state
    else:
        rnd = np.random.RandomState(random_state)
    return int(rnd.randint(np.iinfo("i").max))


class SVC:
    """scikit-learn 1.9.0's ``SVC`` for ``kernel`` ``"precomputed"`` and
    ``"rbf"`` (C-SVC, libsvm's solver copied; see the module docstring)."""

    def __init__(self, C: float = 1.0, kernel: str = "rbf", gamma="scale",
                 probability: bool = False, random_state=None):
        if kernel not in ("rbf", "precomputed"):
            raise ValueError(f"SVC kernel {kernel!r} is not ported (rbf, precomputed)")
        self.C, self.kernel, self.gamma = float(C), kernel, gamma
        self.probability, self.random_state = bool(probability), random_state

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y).ravel()
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        if len(self.classes_) < 2:
            raise ValueError("The number of classes has to be greater than one; "
                             f"got {len(self.classes_)} class")
        if self.kernel == "precomputed":
            if X.shape[0] != X.shape[1]:
                raise ValueError("Precomputed matrix must be a square matrix."
                                 f" Input is a {X.shape[0]}x{X.shape[1]} matrix.")
            self._gamma = 0.0
        elif isinstance(self.gamma, str):
            if self.gamma == "scale":
                var = X.var()
                self._gamma = 1.0 / (X.shape[1] * var) if var != 0 else 1.0
            elif self.gamma == "auto":
                self._gamma = 1.0 / X.shape[1]
            else:
                raise ValueError(f"unknown gamma {self.gamma!r}")
        else:
            self._gamma = float(self.gamma)
        seed = _seed_of(self.random_state)
        self._kern = _Kernel(self.kernel, X, self._gamma)
        self._model = _svm_train(self._kern, np.arange(len(y_enc)), y_enc.astype(np.int64),
                                 self.C, {}, self.probability, seed, _MT())
        self.support_ = self._model.sv_ind.astype(np.int32)
        self.n_support_ = self._model.nSV.astype(np.int32)
        if self.kernel != "precomputed":
            self.support_vectors_ = X[self.support_]
        self.shape_fit_ = X.shape
        return self

    def _kvalue(self, X):
        X = np.asarray(X, np.float64)
        if self.kernel == "precomputed" and X.shape[1] != self.shape_fit_[0]:
            raise ValueError(f"X.shape[1] = {X.shape[1]} should be equal to "
                             f"{self.shape_fit_[0]}, the number of samples at training time")
        return self._kern.predict(X, self._model.sv_ind)

    def _dec(self, X):
        return _decision_values(self._model, self._kvalue(X))

    def decision_function(self, X):
        """Two classes: libsvm's value, sign flipped; more:
        ``decision_function_shape="ovr"`` (scikit-learn's default)."""
        dec = self._dec(X)
        k = len(self.classes_)
        if k == 2:
            return -dec.ravel()
        return _ovr_decision_function(dec < 0, -dec, k)

    def predict(self, X):
        idx = _vote(self._model, self._dec(X))
        return self.classes_.take(np.asarray(self._model.labels)[idx])

    def predict_proba(self, X):
        if not self.probability:
            raise AttributeError("predict_proba is not available when probability=False")
        dec = self._dec(X)
        m, k = self._model, len(self.classes_)
        min_prob = 1e-7
        out = np.empty((len(dec), k))
        for n in range(len(dec)):
            r = [[0.0] * k for _ in range(k)]
            p = 0
            for i in range(k):
                for j in range(i + 1, k):
                    v = min(max(_sigmoid_predict(float(dec[n, p]), m.probA[p], m.probB[p]),
                                min_prob), 1 - min_prob)
                    r[i][j], r[j][i] = v, 1 - v
                    p += 1
            out[n] = _multiclass_probability(k, r)
        return out

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).ravel()))


def _ovr_decision_function(predictions, confidences, n_classes):
    """scikit-learn's one-vs-rest decision from one-vs-one values."""
    n_samples = predictions.shape[0]
    votes = np.zeros((n_samples, n_classes))
    sum_of_confidences = np.zeros((n_samples, n_classes))
    k = 0
    for i in range(n_classes):
        for j in range(i + 1, n_classes):
            sum_of_confidences[:, i] -= confidences[:, k]
            sum_of_confidences[:, j] += confidences[:, k]
            votes[predictions[:, k] == 0, i] += 1
            votes[predictions[:, k] == 1, j] += 1
            k += 1
    transformed = sum_of_confidences / (3 * (np.abs(sum_of_confidences) + 1))
    return votes + transformed


class KernelRidge:
    """scikit-learn 1.9.0's ``KernelRidge(kernel="precomputed")``:
    ``dual_coef = solve(K + αI, y)`` by Cholesky (``assume_a="pos"``),
    predictions ``K_test @ dual_coef``."""

    def __init__(self, alpha: float = 1.0, kernel: str = "precomputed"):
        if kernel != "precomputed":
            raise ValueError(f"KernelRidge kernel {kernel!r} is not ported (precomputed)")
        self.alpha, self.kernel = alpha, kernel

    def fit(self, X, y):
        from scipy import linalg

        K = np.array(X, np.float64)  # a copy: the diagonal is shifted
        y = np.asarray(y, np.float64)
        ravel = y.ndim == 1
        if ravel:
            y = y.reshape(-1, 1)
        n = K.shape[0]
        alpha = np.atleast_1d(self.alpha)
        K.flat[:: n + 1] += alpha[0]
        try:
            dual = linalg.solve(K, y, assume_a="pos", overwrite_a=False)
        except np.linalg.LinAlgError:
            dual = linalg.lstsq(K, y)[0]
        self.dual_coef_ = dual.ravel() if ravel else dual
        return self

    def predict(self, X):
        return np.dot(np.asarray(X, np.float64), self.dual_coef_)

    def score(self, X, y) -> float:
        from kgcn_tpu_torch.runtime.metrics import r2_score

        return float(r2_score(y, self.predict(X)))


def rbf_kernel(X, Y, gamma):
    """scikit-learn's ``rbf_kernel`` on float64 arrays: ``exp(-γ d²)`` with
    ``d² = max(0, -2 X Yᵀ + |x|² + |y|²)`` (0 on the diagonal of ``X`` against
    itself)."""
    XX = np.einsum("ij,ij->i", X, X)[:, None]
    YY = XX.T if Y is X else np.einsum("ij,ij->i", Y, Y)[None, :]
    d = -2 * (X @ Y.T)
    d += XX
    d += YY
    np.maximum(d, 0, out=d)
    if X is Y:
        np.fill_diagonal(d, 0)
    d *= -gamma
    np.exp(d, out=d)
    return d


class _LabelPropagationBase:
    """What both label propagations share (the rbf kernel alone)."""

    _variant = "propagation"

    def __init__(self, gamma=20, alpha=None, max_iter=30, tol=1e-3):
        self.gamma, self.alpha = gamma, alpha
        self.max_iter, self.tol = max_iter, tol

    def _build_graph(self):
        raise NotImplementedError

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.X_ = X
        graph = self._build_graph()
        classes = np.unique(y)
        classes = classes[classes != -1]
        self.classes_ = classes
        n_samples, n_classes = len(y), len(classes)
        unlabeled = y == -1
        self.label_distributions_ = np.zeros((n_samples, n_classes))
        for label in classes:
            self.label_distributions_[y == label, classes == label] = 1
        y_static = np.copy(self.label_distributions_)
        if self._variant == "propagation":
            y_static[unlabeled] = 0
        else:
            y_static *= 1 - self.alpha
        l_previous = np.zeros((n_samples, n_classes))
        unlabeled = unlabeled[:, np.newaxis]
        for self.n_iter_ in range(self.max_iter):
            if np.abs(self.label_distributions_ - l_previous).sum() < self.tol:
                break
            l_previous = self.label_distributions_
            self.label_distributions_ = graph @ self.label_distributions_
            if self._variant == "propagation":
                normalizer = np.sum(self.label_distributions_, axis=1)[:, np.newaxis]
                normalizer[normalizer == 0] = 1
                self.label_distributions_ /= normalizer
                self.label_distributions_ = np.where(
                    unlabeled, self.label_distributions_, y_static)
            else:
                self.label_distributions_ = (
                    np.multiply(self.alpha, self.label_distributions_) + y_static)
        else:
            self.n_iter_ += 1
        normalizer = np.sum(self.label_distributions_, axis=1)[:, np.newaxis]
        normalizer[normalizer == 0] = 1
        self.label_distributions_ /= normalizer
        self.transduction_ = self.classes_[np.argmax(self.label_distributions_, axis=1)].ravel()
        return self

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        weights = rbf_kernel(self.X_, X, self.gamma).T
        probabilities = weights @ self.label_distributions_
        normalizer = np.atleast_2d(np.sum(probabilities, axis=1)).T
        probabilities /= normalizer
        return probabilities

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)].ravel()

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).ravel()))


class LabelPropagation(_LabelPropagationBase):
    """scikit-learn 1.9.0's ``LabelPropagation`` (rbf, ``gamma=20``,
    ``max_iter=1000``, ``tol=1e-3``)."""

    _variant = "propagation"

    def __init__(self, gamma=20, max_iter=1000, tol=1e-3):
        super().__init__(gamma=gamma, alpha=None, max_iter=max_iter, tol=tol)

    def _build_graph(self):
        affinity = rbf_kernel(self.X_, self.X_, self.gamma)
        normalizer = affinity.sum(axis=1)
        affinity /= normalizer[:, np.newaxis]
        return affinity


class LabelSpreading(_LabelPropagationBase):
    """scikit-learn 1.9.0's ``LabelSpreading`` (rbf, ``gamma=20``,
    ``alpha=0.2``, ``max_iter=30``, ``tol=1e-3``): the normalised graph
    Laplacian's negation with a zero diagonal."""

    _variant = "spreading"

    def __init__(self, gamma=20, alpha=0.2, max_iter=30, tol=1e-3):
        super().__init__(gamma=gamma, alpha=alpha, max_iter=max_iter, tol=tol)

    def _build_graph(self):
        from scipy.sparse.csgraph import laplacian

        n = self.X_.shape[0]
        affinity = rbf_kernel(self.X_, self.X_, self.gamma)
        lap = -laplacian(affinity, normed=True)
        lap.flat[:: n + 1] = 0.0
        return lap

