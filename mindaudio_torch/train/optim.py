"""AdamW as ``optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype)`` computes it.

The Conformer recipe keeps the first moment in bf16 (it halves that moment's
memory traffic) and the second moment and the parameters in float32;
``torch.optim.AdamW`` has no such option, so this is the port's own. Both
moments live in one flat buffer each (the per-parameter moments are views of
it) and the gradients are gathered into one, so the moment arithmetic is a
dozen elementwise passes over all parameters at once, whatever their number;
only the parameters themselves, which the model owns, are updated through
``torch._foreach_*`` operators. As in optax:

- ``m = b1*m + (1-b1)*g``, where ``b1*m`` is formed in the stored moment's
  dtype and the sum in float32; the update uses that float32 value and the
  moment is rounded to ``mu_dtype`` on store;
- ``v = b2*v + (1-b2)*g^2``; both are bias-corrected by ``1 - b^count`` with
  the incremented count;
- ``eps`` is added outside the square root;
- the weight decay is decoupled and applies to every parameter (biases and
  LayerNorm too), or with ``decay=`` to the parameters it names (optax's
  ``mask``; ``utils.common.set_weight_decay`` gives the JAX package's):
  ``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
- a schedule is read at the count before the increment.

The step count and the learning rate live on the device, and
:meth:`AdamW.step` takes the "apply this update" flag as a device scalar, so
a train step has no host synchronisation of its own.

ZeRO-1 (``zero1_group``, the ``data`` group of ``parallel.mesh``): the flat
moment buffers are cut into equal slices, one a rank, so each rank stores
``1 / n`` of them; a step updates this rank's slice of the flat parameters
with the whole (already averaged) gradient's slice, and the updated slices
are all-gathered into the parameters. The JAX package shards each moment
leaf along its first divisible dimension instead (``_zero1_spec``); the
update is elementwise, so the layout does not change a value, and the
trajectory is bit for bit the replicated one.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather_tensor, group_rank, group_size

__all__ = ["AdamW"]


class AdamW:
    """See the module docstring.

    Args:
        named_params: iterable of ``(name, parameter)``, e.g.
            ``model.named_parameters()``; all on one device, float32.
        lr: a float, or a schedule ``step tensor -> lr tensor``.
        mu_dtype: dtype of the stored first moment (the recipe's default is
            bf16; ``None`` keeps float32).
        decay: names of the parameters the weight decay applies to (``None``:
            all of them).
        zero1_group: a process group to shard the moments over (ZeRO-1), or
            ``None`` to keep them whole.
    """

    def __init__(self, named_params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
                 mu_dtype=None, decay=None, zero1_group=None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if decay is not None:
            unknown = set(decay) - set(self.names)
            if unknown:
                raise KeyError(f"AdamW: decay names no parameter: {sorted(unknown)[:8]}")
            decay = set(decay)
        self._decayed = [i for i, n in enumerate(self.names) if decay is None or n in decay]
        self.lr, self.b1, self.b2, self.eps, self.weight_decay = lr, b1, b2, eps, weight_decay
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        # (b, 1 - b) pairs, each rounded to float32 from the Python float
        self._b1 = torch.tensor([b1, 1.0 - b1], dtype=torch.float32, device=device)
        self._b2 = torch.tensor([b2, 1.0 - b2], dtype=torch.float32, device=device)
        self._sizes = [p.numel() for p in self.params]
        total = sum(self._sizes)
        self.zero1_group = zero1_group
        n = group_size(zero1_group)
        self._chunk = -(-total // n)
        self._lo = group_rank(zero1_group) * self._chunk
        stored = total if n == 1 else self._chunk
        self._mu = torch.zeros(stored, dtype=mu_dtype or torch.float32, device=device)
        self._nu = torch.zeros(stored, dtype=torch.float32, device=device)
        if n == 1:
            self.mu, self.nu = self._views(self._mu), self._views(self._nu)
        else:
            decayed = torch.zeros(n * self._chunk, dtype=torch.bool, device=device)
            for v, i in zip(decayed[:total].split(self._sizes), range(len(self.params))):
                v.fill_(i in self._decayed)
            self._decay_mask = decayed[self._lo:self._lo + self._chunk]

    def _views(self, flat):
        """``flat`` cut into one view per parameter, in the parameter's shape."""
        return [v.view(p.shape) for v, p in zip(flat.split(self._sizes), self.params)]

    def _flat_slice(self, tensors):
        """This rank's ZeRO-1 slice of ``tensors`` flattened (zero-padded)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        pad = group_size(self.zero1_group) * self._chunk - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat[self._lo:self._lo + self._chunk]

    def _gathered(self, chunk):
        """The whole flat buffer from every rank's slice, cut per parameter."""
        flat = all_gather_tensor(chunk, self.zero1_group)[:sum(self._sizes)]
        return self._views(flat)

    def _lr(self):
        if callable(self.lr):
            return self.lr(self.count).to(torch.float32)
        return torch.full((), self.lr, dtype=torch.float32, device=self.count.device)

    @torch.no_grad()
    def step(self, grads, ok=None):
        """One update from ``grads`` (a list aligned with the parameters).

        ``ok`` is an optional boolean device scalar. Where it is False the
        parameters, both moments and the count keep their values exactly, as
        optax's state does when the JAX package skips a step: the gradients
        are replaced by zeros, the decay rates by 1 and the learning rate by
        0, and the count advances by ``ok``, all selected on the device.
        """
        lr = self._lr()
        (b1, g1), (b2, g2) = self._b1, self._b2
        sharded = group_size(self.zero1_group) > 1
        g = (self._flat_slice(grads) if sharded
             else torch.cat([x.reshape(-1) for x in grads])).to(torch.float32)
        if ok is not None:
            g = torch.where(ok, g, 0.0)
            b1, b2 = torch.where(ok, b1, 1.0), torch.where(ok, b2, 1.0)
            g1, g2 = torch.where(ok, g1, 0.0), torch.where(ok, g2, 0.0)
            lr = torch.where(ok, lr, 0.0)
        self.count += 1 if ok is None else ok.to(self.count.dtype)

        # optax forms b1 * m in the stored moment's dtype (its Python-float
        # decay takes the array's type), then adds (1 - b1) * g in float32
        m = (self._mu * b1.to(self._mu.dtype)).float().add_(g * g1)
        self._nu.mul_(b2).add_(g.square_().mul_(g2))
        self._mu.copy_(m)  # rounds to mu_dtype

        # float32 powers of Python-float decay rates, as optax takes them
        count = self.count.to(torch.float32)
        correction1 = 1.0 - torch.pow(self._b1[0], count)
        correction2 = 1.0 - torch.pow(self._b2[0], count)
        update = m.div_(correction1).div_((self._nu / correction2).sqrt_().add_(self.eps))
        if sharded:
            # the replicated arithmetic below, on this rank's slice
            p = self._flat_slice(self.params)
            update = torch.where(self._decay_mask, update + p * self.weight_decay, update)
            for t, new in zip(self.params, self._gathered(p - update * lr)):
                t.copy_(new)
            return
        update = self._views(update)
        if self._decayed:
            torch._foreach_add_([update[i] for i in self._decayed], torch._foreach_mul(
                [self.params[i] for i in self._decayed], self.weight_decay))
        torch._foreach_sub_(self.params, torch._foreach_mul(update, lr))

    def moments(self):
        """``(mu, nu)``: per parameter, each moment whole (gathered from the
        ranks' slices under ZeRO-1)."""
        if group_size(self.zero1_group) == 1:
            return self.mu, self.nu
        return self._gathered(self._mu), self._gathered(self._nu)

    def state_dict(self):
        """``{"count", "mu": {name: tensor}, "nu": {name: tensor}}``, whole
        under ZeRO-1 too (every rank of the group must call it)."""
        mu, nu = self.moments()
        return {"count": self.count.clone(),
                "mu": {n: t.clone() for n, t in zip(self.names, mu)},
                "nu": {n: t.clone() for n, t in zip(self.names, nu)}}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Load a :meth:`state_dict` (or ``convert.convert_adamw_state``'s
        result); moments are cast to this optimizer's dtypes and device."""
        self.count.copy_(torch.as_tensor(state["count"]))
        for key, flat in (("mu", self._mu), ("nu", self._nu)):
            missing = set(self.names) ^ set(state[key])
            if missing:
                raise KeyError(f"AdamW.load_state_dict: {key} names differ: {sorted(missing)}")
            whole = [torch.as_tensor(state[key][n]).to(flat.device, flat.dtype).reshape(-1)
                     for n in self.names]
            if group_size(self.zero1_group) == 1:
                for t, w in zip(self._views(flat), whole):
                    t.copy_(w.view(t.shape))
            else:
                flat.copy_(self._flat_slice(whole))
