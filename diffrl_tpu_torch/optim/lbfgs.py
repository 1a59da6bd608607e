"""L-BFGS with a zoom line search on a flat parameter vector: the algorithm
of ``optax.lbfgs(learning_rate=None, memory_size=10,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=8))``,
which the JAX package's BPTT takes for ``algo: lbfgs``
(diffrl_tpu/algorithms/bptt.py).

One update from parameters w with value f(w) and gradient u:

1. the memory: the differences dw = w - w_prev and du = u - u_prev enter
   slot (k - 1) mod m with weight 1 / <du, dw> (0 where that is 0; all
   three 0 at the first update);
2. the direction d = -P u by the two-loop recursion over the memory, P's
   initial scaling <du, dw> / |du|^2 (1 where |du| = 0), and
   min(1, 1 / |u|) at the first update;
3. the zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6, with
   Hager and Zhang's approximate decrease test) for a step t along d:
   each probe evaluates f and its gradient at w + t d; the first probe
   tries the step the last search took (1.0 at first), the interval
   search doubles it; the zoom interpolates (cubic, else quadratic, else
   bisection) inside the bracketing interval. It stops when a probe
   satisfies the strong Wolfe conditions (decrease with slope_rtol 1e-4,
   curvature with curv_rtol 0.9), or after 8 probes or an interval under
   1e-5 with a safe step found; then it takes the safe step (sufficient
   decrease) where there is one, else the last probe;
4. w <- w + t d.

Scalars are float32 tensors on the parameters' device and every branch is
a ``torch.where``, as in optax's traced code, so the iterates follow
optax's in float32. The search reads one flag back to the host per probe.
This is not ``torch.optim.LBFGS``, whose line search differs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Sequence, Tuple

import torch

Tensor = torch.Tensor

# optax.lbfgs's memory_size=10 and scale_by_zoom_linesearch's
# max_linesearch_steps=8, as the JAX BPTT sets them, and the search's
# defaults (optax/_src/linesearch.py)
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 8
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5


def _vdot(a: Tensor, b: Tensor, sizes: Sequence[int]) -> Tensor:
    """<a, b> summed per parameter, in parameter order (optax's tree vdot
    sums one dot product per leaf)."""
    return sum(torch.dot(x, y) for x, y in zip(a.split(sizes), b.split(sizes)))


def _sqnorm(a: Tensor, sizes: Sequence[int]) -> Tensor:
    return sum(torch.sum(x * x) for x in a.split(sizes))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 - db ** 2 * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


@dataclass
class _Search:
    """The zoom line search's state (optax's ZoomLinesearchState)."""

    count: int
    stepsize: Tensor
    value: Tensor
    grad: Tensor
    slope: Tensor
    decrease_error: Tensor
    curvature_error: Tensor
    interval_found: Tensor
    done: Tensor
    failed: Tensor
    low: Tensor
    value_low: Tensor
    slope_low: Tensor
    high: Tensor
    value_high: Tensor
    slope_high: Tensor
    cubic_ref: Tensor
    value_cubic_ref: Tensor
    safe_stepsize: Tensor
    safe_value: Tensor
    safe_grad: Tensor


class LBFGS:
    """optax.lbfgs with the zoom line search over ``params`` (updated in
    place, as one flat vector in their order).

    ``step(value, grad, value_and_grad_fn)`` takes f and its gradient at
    the current parameters (flat, as ``flat_grad`` gives them) and
    ``value_and_grad_fn(w_flat) -> (value, flat gradient)``, which
    evaluates f at a probe. ``linesearch_steps`` is the last search's
    number of probes, ``learning_rate`` its step.
    """

    def __init__(self, params: Sequence[Tensor]):
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        p0 = self.params[0]
        n = sum(self.sizes)
        self.count = 0
        self.prev_params = p0.new_zeros(n)
        self.prev_updates = p0.new_zeros(n)
        self.diff_params = p0.new_zeros((MEMORY_SIZE, n))
        self.diff_updates = p0.new_zeros((MEMORY_SIZE, n))
        self.weights = p0.new_zeros(MEMORY_SIZE)
        self.learning_rate = self._scalar(1.0)
        self.linesearch_steps = 0

    def _scalar(self, x) -> Tensor:
        return torch.full((), x, dtype=self.prev_params.dtype,
                          device=self.prev_params.device)

    # -- flat views -------------------------------------------------------

    def flat_params(self) -> Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    def flat_grad(self, grads: Sequence[Tensor]) -> Tensor:
        return torch.cat([g.reshape(-1) for g in grads])

    @torch.no_grad()
    def set_params(self, flat: Tensor):
        for p, x in zip(self.params, flat.split(self.sizes)):
            p.copy_(x.reshape(p.shape))

    # -- scale_by_lbfgs -----------------------------------------------------

    def direction(self, w: Tensor, u: Tensor) -> Tensor:
        """The preconditioned update P u (optax's scale_by_lbfgs), after
        the memory takes in the last step's differences."""
        m, sz = MEMORY_SIZE, self.sizes
        idx = self.count % m
        prev = (self.count - 1) % m
        first = self.count == 0
        dw = w - self.prev_params
        du = u - self.prev_updates
        vd = _vdot(du, dw, sz)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        if first:
            dw, du, weight = (torch.zeros_like(x) for x in (dw, du, weight))
        self.diff_params[prev] = dw
        self.diff_updates[prev] = du
        self.weights[prev] = weight

        num = _vdot(du, dw, sz)
        den = _sqnorm(du, sz)
        scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
        if first:
            scale = torch.clamp(1.0 / torch.sqrt(_sqnorm(u, sz)), max=1.0)

        order = [(idx + i) % m for i in range(m)]
        vec, alphas = u, {}
        for i in reversed(order):
            alphas[i] = self.weights[i] * _vdot(self.diff_params[i], vec, sz)
            vec = vec + (-alphas[i]) * self.diff_updates[i]
        vec = scale * vec
        for i in order:
            beta = self.weights[i] * _vdot(self.diff_updates[i], vec, sz)
            vec = vec + (alphas[i] - beta) * self.diff_params[i]
        self.count += 1
        self.prev_params, self.prev_updates = w, u
        return vec

    # -- the zoom line search -----------------------------------------------

    def _errors(self, t, value, slope, value_init, slope_init):
        dec = value - value_init - SLOPE_RTOL * t * slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        dec = torch.minimum(torch.maximum(approx, delta), dec)
        dec = torch.clamp(dec, min=0.0)
        dec = torch.where(torch.isnan(dec), torch.full_like(dec, torch.inf),
                          dec)
        curv = torch.clamp(torch.abs(slope) - CURV_RTOL
                           * torch.abs(slope_init), min=0.0)
        curv = torch.where(torch.isnan(curv), torch.full_like(curv, torch.inf),
                           curv)
        return dec, curv

    def _probe(self, w, d, t, fn):
        value, grad = fn(w + t * d)
        value = torch.as_tensor(value, dtype=w.dtype, device=w.device)
        return value, grad, _vdot(grad, d, self.sizes)

    def _search_interval(self, st: _Search, w, d, f0, g0, fn) -> _Search:
        W = torch.where
        guess, prev_t = self.learning_rate, st.stepsize
        t = guess if st.count == 0 else INCREASE_FACTOR * prev_t
        value, grad, slope = self._probe(w, d, t, fn)
        dec, curv = self._errors(t, value, slope, f0, g0)
        err = torch.maximum(dec, curv)
        safe = dec <= 0.0
        high_new = (dec > 0.0) | ((value >= st.value) & (st.count > 0))
        low_new = (slope >= 0.0) & ~high_new
        found = high_new | low_new | (err <= 0.0)
        done = err <= 0.0
        low = W(low_new, t, prev_t)
        value_low = W(low_new, value, st.value)
        slope_low = W(low_new, slope, st.slope)
        return _Search(
            count=st.count + 1, stepsize=t, value=value, grad=grad,
            slope=slope, decrease_error=dec, curvature_error=curv,
            interval_found=found, done=done,
            failed=(st.count + 1 >= MAX_LINESEARCH_STEPS) & ~done,
            low=low, value_low=value_low, slope_low=slope_low,
            high=W(low_new, prev_t, t), value_high=W(low_new, st.value, value),
            slope_high=W(low_new, st.slope, slope),
            cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=W(safe, t, st.safe_stepsize),
            safe_value=W(safe, value, st.safe_value),
            safe_grad=W(safe, grad, st.safe_grad))

    def _zoom(self, st: _Search, w, d, f0, g0, fn) -> _Search:
        W = torch.where
        low, high = st.low, st.high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic = _cubicmin(low, st.value_low, st.slope_low, high,
                          st.value_high, st.cubic_ref, st.value_cubic_ref)
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right
                                                     - 0.2 * delta)
        quad = _quadmin(low, st.value_low, st.slope_low, high, st.value_high)
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (
            quad < right - 0.1 * delta)
        use_bisection = ~use_cubic & ~use_quad
        t = W(use_cubic, cubic, st.cubic_ref)
        t = W(use_quad, quad, t)
        t = W(use_bisection, (low + high) / 2.0, t)
        value, grad, slope = self._probe(w, d, t, fn)
        dec, curv = self._errors(t, value, slope, f0, g0)
        err = torch.maximum(dec, curv)
        upd_safe = (dec <= 0.0) & (value < st.safe_value)
        safe_t = W(upd_safe, t, st.safe_stepsize)
        done = err <= 0.0
        high_mid = (dec > 0.0) | (value >= st.value_low)
        high_low = (slope * (high - low) >= 0.0) & ~high_mid
        low_mid = ~high_mid
        nh = [W(high_mid, a, b) for a, b in ((t, high), (value, st.value_high),
                                            (slope, st.slope_high))]
        nh = [W(high_low, a, b) for a, b in zip(
            (low, st.value_low, st.slope_low), nh)]
        nl = [W(low_mid, a, b) for a, b in ((t, low), (value, st.value_low),
                                           (slope, st.slope_low))]
        ref_high = high_mid | high_low
        too_small = delta <= STEPSIZE_PRECISION
        max_iter = st.count + 1 >= MAX_LINESEARCH_STEPS
        failed = (max_iter | (too_small & (safe_t > 0.0))) & ~done
        return _Search(
            count=st.count + 1, stepsize=t, value=value, grad=grad,
            slope=slope, decrease_error=dec, curvature_error=curv,
            interval_found=st.interval_found, done=done, failed=failed,
            low=nl[0], value_low=nl[1], slope_low=nl[2],
            high=nh[0], value_high=nh[1], slope_high=nh[2],
            cubic_ref=W(ref_high, high, low),
            value_cubic_ref=W(ref_high, st.value_high, st.value_low),
            safe_stepsize=safe_t,
            safe_value=W(upd_safe, value, st.safe_value),
            safe_grad=W(upd_safe, grad, st.safe_grad))

    @staticmethod
    def _try_safe_step(st: _Search) -> _Search:
        take = (st.safe_stepsize > 0.0) | torch.isinf(st.decrease_error)
        return replace(st, stepsize=torch.where(take, st.safe_stepsize,
                                                st.stepsize),
                       value=torch.where(take, st.safe_value, st.value),
                       grad=torch.where(take, st.safe_grad, st.grad))

    def linesearch(self, w: Tensor, d: Tensor, value: Tensor, grad: Tensor,
                   fn: Callable[[Tensor], Tuple[Tensor, Tensor]]) -> Tensor:
        """The zoom line search along ``d`` from ``w`` (value and gradient
        there given); returns the step and sets ``learning_rate`` and
        ``linesearch_steps``."""
        f0 = torch.as_tensor(value, dtype=w.dtype, device=w.device)
        g0 = _vdot(d, grad, self.sizes)
        zero, inf = self._scalar(0.0), self._scalar(torch.inf)
        false = torch.zeros((), dtype=torch.bool, device=w.device)
        st = _Search(
            count=0, stepsize=zero, value=f0, grad=grad, slope=g0,
            decrease_error=inf, curvature_error=inf, interval_found=false,
            done=false, failed=false, low=zero, value_low=f0, slope_low=g0,
            high=zero, value_high=f0, slope_high=g0, cubic_ref=zero,
            value_cubic_ref=f0, safe_stepsize=zero, safe_value=f0,
            safe_grad=grad)
        while True:
            st = (self._zoom if bool(st.interval_found)
                  else self._search_interval)(st, w, d, f0, g0, fn)
            if bool(st.failed):
                st = self._try_safe_step(st)
            if bool(st.done | st.failed):
                break
        self.learning_rate = st.stepsize
        self.linesearch_steps = st.count
        return st.stepsize

    @torch.no_grad()
    def step(self, value, grad: Tensor,
             value_and_grad_fn: Callable[[Tensor], Tuple[Tensor, Tensor]]
             ) -> Tensor:
        """One L-BFGS update of the parameters from the value and flat
        gradient at them; ``value_and_grad_fn`` evaluates a probe. Returns
        the step taken."""
        w = self.flat_params()
        d = -self.direction(w, grad)
        t = self.linesearch(w, d, value, grad, value_and_grad_fn)
        self.set_params(w + t * d)
        return t

    # -- checkpoints --------------------------------------------------------

    _STATE = ("count", "prev_params", "prev_updates", "diff_params",
              "diff_updates", "weights", "learning_rate")

    def state_dict(self):
        return {k: getattr(self, k) for k in self._STATE}

    def load_state_dict(self, state):
        for k in self._STATE:
            v = state[k]
            setattr(self, k, v if isinstance(v, int) else
                    torch.as_tensor(v).to(self.prev_params.device))
