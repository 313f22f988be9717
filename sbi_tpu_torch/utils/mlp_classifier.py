"""T independent ReLU MLP binary classifiers, trained as one batched program.

The port's counterpart of the sklearn ``MLPClassifier`` that the JAX
package builds for C2ST (``sbi_tpu/utils/metrics.py:63-70``) and LC2ST
(``sbi_tpu/diagnostics/lc2st.py:45-58``). It follows sklearn's algorithm
(``sklearn/neural_network/_multilayer_perceptron.py``, ``solver="adam"``):

- Glorot-uniform weights and intercepts, bound sqrt(6 / (fan_in + fan_out));
- log-loss of a logistic output plus alpha * ||W||^2 / 2 over the batch
  size, with the gradients of sklearn's ``_backprop``;
- Adam with sklearn's step, lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps);
- mini-batches of ``min(200, n)`` rows, reshuffled each epoch;
- with ``early_stopping``, a stratified validation split: a member stops
  after ``n_iter_no_change`` epochs whose validation accuracy gains less
  than ``tol`` and keeps its best weights; without it, it stops on the
  training loss.

Member t's weights are slices of one (T, P) buffer, its data are row t of
(T, n, d), and its draws (initial weights, split, shuffles) come from its
own generator, seeded by ``random_state[t]``, so a member trained alone
equals the same member trained in a batch. A member that has stopped is
masked out of further updates; the epoch loop reads "all stopped" on the
host once an epoch. It is not bit-equal to sklearn: its random streams are
torch's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .sbiutils import resolve_device

# sklearn's defaults, which every caller in the JAX package keeps: the L2
# penalty, Adam's rate, betas and epsilon, the tolerance of the stopping
# rule, the validation share and the largest mini-batch.
ALPHA, LEARNING_RATE, BETA_1, BETA_2, EPSILON = 1e-4, 1e-3, 0.9, 0.999, 1e-8
TOL, VALIDATION_FRACTION, MAX_BATCH = 1e-4, 0.1, 200


class BatchedMLPClassifier:
    def __init__(
        self,
        hidden_layer_sizes: Sequence[int] = (100,),
        max_iter: int = 200,
        random_state: Optional[Sequence[int]] = None,
        early_stopping: bool = False,
        n_iter_no_change: int = 10,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        """``random_state``: one seed a member (None: drawn from numpy's
        global state, as sklearn's None). ``device=None`` takes the data's
        device in ``fit`` (cuda for numpy data)."""
        self.hidden_layer_sizes = tuple(int(h) for h in hidden_layer_sizes)
        self.max_iter = max_iter
        self.random_state = random_state
        self.early_stopping = early_stopping
        self.n_iter_no_change = n_iter_no_change
        self.device = device
        self.dtype = dtype

    # ------------------------------------------------------------- weights
    def _set_layout(self, units: Sequence[int]) -> None:
        """Offsets of each layer's (fan_in, fan_out) weights and fan_out
        intercepts in the flat parameter row, layer after layer."""
        self._units = tuple(units)
        self._slices, offset = [], 0
        for fi, fo in zip(units[:-1], units[1:]):
            self._slices.append(((offset, fi, fo), (offset + fi * fo, fo)))
            offset += fi * fo + fo
        self._num_params = offset

    def _views(self, flat: torch.Tensor):
        """[(W (T, fi, fo), b (T, fo))] as views of ``flat`` (T, P)."""
        T = flat.shape[0]
        return [(flat[:, w0:w0 + fi * fo].view(T, fi, fo), flat[:, b0:b0 + fo])
                for (w0, fi, fo), (b0, fo) in self._slices]

    @property
    def coefs_(self):
        return [w for w, _ in self._views(self._flat)]

    @property
    def intercepts_(self):
        return [b for _, b in self._views(self._flat)]

    @property
    def num_members(self) -> int:
        return self._flat.shape[0]

    @classmethod
    def from_weights(cls, coefs, intercepts, device=None,
                     dtype: torch.dtype = torch.float32) -> "BatchedMLPClassifier":
        """A fitted classifier from stacked weights: ``coefs[l]`` (T, fi,
        fo), ``intercepts[l]`` (T, fo), as arrays or tensors."""
        coefs = [torch.as_tensor(np.asarray(c), dtype=dtype) for c in coefs]
        intercepts = [torch.as_tensor(np.asarray(b), dtype=dtype) for b in intercepts]
        units = [coefs[0].shape[1]] + [c.shape[2] for c in coefs]
        clf = cls(hidden_layer_sizes=units[1:-1], device=device, dtype=dtype)
        clf.device = resolve_device(device)
        clf._set_layout(units)
        clf._flat = torch.cat([t.reshape(t.shape[0], -1) for c, b in zip(coefs, intercepts)
                               for t in (c, b)], dim=1).to(clf.device)
        return clf

    def _init_flat(self, generators) -> torch.Tensor:
        """Glorot-uniform weights and intercepts (sklearn's ``_init_coef``
        with ReLU's factor 6), member by member from its generator."""
        rows = []
        for g in generators:
            parts = []
            for fi, fo in zip(self._units[:-1], self._units[1:]):
                bound = math.sqrt(6.0 / (fi + fo))
                for shape in ((fi * fo,), (fo,)):
                    u = torch.rand(shape, generator=g, device=self.device, dtype=self.dtype)
                    parts.append((2 * u - 1) * bound)
            rows.append(torch.cat(parts))
        return torch.stack(rows)

    # ------------------------------------------------------------- forward
    def _forward(self, flat: torch.Tensor, X: torch.Tensor):
        """Activations [X, h_1, ..., h_L] and the logits (T, n). ``X`` is
        (T, n, d), or (n, d) shared by all members."""
        acts = [X]
        a = X
        layers = self._views(flat)
        for i, (w, b) in enumerate(layers):
            z = torch.matmul(a, w) + b[:, None, :]
            if i < len(layers) - 1:
                a = torch.relu(z)
                acts.append(a)
        return acts, z[..., 0]

    def decision_function(self, X) -> torch.Tensor:
        """Logits (T, n) of X (T, n, d) or (n, d)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            return self._forward(self._flat, X)[1]

    def predict_proba(self, X) -> torch.Tensor:
        """P(class 1), (T, n), for X (T, n, d) or (n, d)."""
        return torch.sigmoid(self.decision_function(X))

    def predict(self, X) -> torch.Tensor:
        """Class labels (T, n): 1 where P(class 1) > 0.5, as sklearn."""
        return (self.decision_function(X) > 0).to(self.dtype)

    def _sum_sq_weights(self, flat: torch.Tensor) -> torch.Tensor:
        return sum((w * w).sum((1, 2)) for w, _ in self._views(flat))

    def _loss_and_grad(self, flat, X, y, w):
        """sklearn's ``_backprop`` for every member: X (T, b, d), labels y
        and row weights w (T, b) in {0, 1}. Returns the regularised mean
        log-loss (T,), the gradient (T, P) and the rows counted (T,)."""
        acts, z = self._forward(flat, X)
        nb = w.sum(1)
        nbc = nb.clamp(min=1)[:, None]
        layers = self._views(flat)
        loss = ((F.softplus(z) - y * z) * w).sum(1, keepdim=True) / nbc
        loss = loss[:, 0] + 0.5 * ALPHA * self._sum_sq_weights(flat) / nbc[:, 0]
        grad = torch.empty_like(flat)
        gviews = self._views(grad)
        delta = ((torch.sigmoid(z) - y) * w)[..., None]  # (T, b, 1): d loss / d z
        for i in range(len(layers) - 1, -1, -1):
            gw, gb = gviews[i]
            gw.copy_(torch.baddbmm(layers[i][0], acts[i].transpose(1, 2), delta, beta=ALPHA))
            gb.copy_(delta.sum(1))
            if i > 0:
                delta = torch.bmm(delta, layers[i][0].transpose(1, 2)) * (acts[i] > 0)
        return loss, grad / nbc, nb

    def loss(self, X, y) -> torch.Tensor:
        """The regularised log-loss (T,) of each member on its rows of X
        (T, n, d) and y (T, n): sklearn's ``_backprop`` loss."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            return self._loss_and_grad(self._flat, X, y, torch.ones_like(y))[0]

    # ----------------------------------------------------------------- fit
    def _validation_mask(self, y: torch.Tensor, valid: torch.Tensor, sizes, generators) -> torch.Tensor:
        """A stratified split of each member's rows, as sklearn's
        ``train_test_split(stratify=y)``: ceil(fraction * n) rows, shared
        among the classes in proportion (the larger remainder takes the
        rounding), drawn at random within each class."""
        T, n = y.shape
        ones = [int(c) for c in ((y > 0.5) & valid).sum(1).tolist()]
        mask = torch.zeros((T, n), dtype=torch.bool, device=self.device)
        for t, (g, size) in enumerate(zip(generators, sizes)):
            counts = (size - ones[t], ones[t])
            n_val = math.ceil(VALIDATION_FRACTION * size)
            exact = [n_val * c / size for c in counts]
            take = [math.floor(e) for e in exact]
            if sum(take) < n_val:
                take[int(np.argmax([e - k for e, k in zip(exact, take)]))] += 1
            key = torch.rand(size, generator=g, device=self.device) + 2 * (y[t, :size] > 0.5)
            order = torch.argsort(key)  # class 0 rows in random order, then class 1's
            chosen = torch.cat([order[:take[0]], order[counts[0]:counts[0] + take[1]]])
            mask[t, chosen] = True
        return mask

    def fit(self, X, y, n_samples: Optional[Sequence[int]] = None) -> "BatchedMLPClassifier":
        """Train member t on rows ``:n_samples[t]`` of X[t] (T, n, d) with
        labels y[t] (T, n) in {0, 1}; all n rows where ``n_samples`` is
        None."""
        if self.device is None and isinstance(X, torch.Tensor):
            self.device = X.device
        self.device = resolve_device(self.device)
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        T, n, d = X.shape
        sizes = [n] * T if n_samples is None else [int(s) for s in n_samples]
        seeds = self.random_state
        if seeds is None:
            seeds = np.random.randint(0, 2**31 - 1, size=T)
        if len(seeds) != T:
            raise ValueError(f"random_state has {len(seeds)} seeds for {T} members")
        generators = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]
        self._set_layout([d, *self.hidden_layer_sizes, 1])
        flat = self._init_flat(generators)

        rows = torch.arange(n, device=self.device)
        valid = rows[None, :] < torch.as_tensor(sizes, device=self.device)[:, None]
        if self.early_stopping:
            val = self._validation_mask(y, valid, sizes, generators)
            val_w = val.to(self.dtype)
            train = valid & ~val
        else:
            train = valid
        train_w = train.to(self.dtype)
        n_train = train_w.sum(1)
        n_train_max = max(s - (math.ceil(VALIDATION_FRACTION * s) if self.early_stopping else 0)
                          for s in sizes)
        bs = min(MAX_BATCH, n_train_max)

        m, v = torch.zeros_like(flat), torch.zeros_like(flat)
        steps = torch.zeros(T, device=self.device, dtype=self.dtype)
        stopped = torch.zeros(T, dtype=torch.bool, device=self.device)
        no_improvement = torch.zeros(T, device=self.device)
        n_iter = torch.zeros(T, dtype=torch.long, device=self.device)
        best_flat = flat.clone()
        best = torch.full((T,), -math.inf if self.early_stopping else math.inf,
                          device=self.device, dtype=self.dtype)
        b1, b2, lr = BETA_1, BETA_2, LEARNING_RATE
        loss_epoch = torch.zeros(T, device=self.device, dtype=self.dtype)
        self.n_steps_ = 0  # batched steps run
        for _ in range(self.max_iter):
            running = ~stopped
            keys = torch.stack([F.pad(torch.rand(s, generator=g, device=self.device), (0, n - s))
                                for g, s in zip(generators, sizes)])
            order = torch.argsort(torch.where(train, keys, 2.0), dim=1)  # training rows first
            total = torch.zeros(T, device=self.device, dtype=self.dtype)
            for start in range(0, n_train_max, bs):
                idx = order[:, start:start + bs]
                xb = X.gather(1, idx[..., None].expand(-1, -1, d))
                yb, wb = y.gather(1, idx), train_w.gather(1, idx)
                loss, grad, nb = self._loss_and_grad(flat, xb, yb, wb)
                total = total + loss * nb
                active = (running & (nb > 0))[:, None]
                steps = steps + active[:, 0]
                m = torch.where(active, torch.add(m * b1, grad, alpha=1 - b1), m)
                v = torch.where(active, torch.add(v * b2, grad * grad, alpha=1 - b2), v)
                lr_t = lr * torch.sqrt(1 - b2 ** steps.clamp(min=1)) / (1 - b1 ** steps.clamp(min=1))
                flat = torch.where(active, flat - lr_t[:, None] * m / (torch.sqrt(v) + EPSILON), flat)
                self.n_steps_ += 1
            n_iter = n_iter + running
            loss_epoch = torch.where(running, total / n_train.clamp(min=1), loss_epoch)
            if self.early_stopping:
                z = self._forward(flat, X)[1]
                score = ((z > 0).to(self.dtype) == y).to(self.dtype).mul(val_w).sum(1) / val_w.sum(1)
                worse = score < best + TOL
                better = running & (score > best)
                best_flat = torch.where(better[:, None], flat, best_flat)
            else:
                score = loss_epoch
                worse = score > best - TOL
                better = running & (score < best)
            best = torch.where(better, score, best)
            no_improvement = torch.where(running, torch.where(worse, no_improvement + 1, 0.0),
                                         no_improvement)
            stopped = stopped | (running & (no_improvement > self.n_iter_no_change))
            if bool(stopped.all()):
                break
        self._flat = best_flat if self.early_stopping else flat
        self.n_iter_, self.n_updates_, self.loss_ = n_iter, steps.long(), loss_epoch
        if self.early_stopping:
            self.best_validation_score_ = best
        else:
            self.best_loss_ = best
        return self
