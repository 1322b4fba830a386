"""The MoE Conformer of U2++ MoE (WeNet team, arXiv:2404.16407; WeNet's
``wenet/transformer/positionwise_feed_forward.py``, ``MoEFFNLayer``) written
out plainly: :mod:`.conformer`'s model with every encoder FFN, the macaron
one and the final one, a mixture of ``E`` experts of which each frame takes
the top ``k``, with the port's parameter names (``gate (D, E)``, ``w1 (E, D,
H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)``).

For the valid frames ``x`` of a block (padding is routed nowhere and gets
zero)::

    l = x . gate;  S = the k largest of l (the first index on ties)
    w_i = exp(l_i) / sum_{j in S} exp(l_j)
    h_i = dropout(swish(x . w1_i + b1_i))
    y = sum_{i in S} w_i (h_i . w2_i + b2_i)

as WeNet's loop over the experts, each taking the frames ``torch.where``
finds routed to it. Every routed frame is computed: there is no capacity and
nothing is dropped. The dropout's bytes come from :class:`.conformer.Dropout`
over the hidden activations laid out ``(rows, T, k, H)``, frame by frame in
the order of their top-k slots, so that they replay the program's draw and
the batch can run in blocks of rows.

Departures from U2++ MoE: the router is computed in float32 whatever the
precision of the products (the port's router is float32 under bf16
autocast); the decoder's FFNs stay dense (the paper names the encoder's);
no auxiliary load-balancing loss (the paper trains without one). With
``moe_experts=0`` the model is :class:`.conformer.Conformer`.
"""

from __future__ import annotations

import torch
from torch import nn

from . import conformer as ref
from .precision import FLOAT32


class MoE(nn.Module):
    """One mixture of experts FFN (Swish experts, bias-free router)."""

    def __init__(self, d, hidden, experts, top_k):
        super().__init__()
        self.top_k = top_k
        self.gate = nn.Parameter(torch.empty(d, experts))
        self.w1 = nn.Parameter(torch.empty(experts, d, hidden))
        self.b1 = nn.Parameter(torch.empty(experts, hidden))
        self.w2 = nn.Parameter(torch.empty(experts, hidden, d))
        self.b2 = nn.Parameter(torch.empty(experts, d))

    def forward(self, x, valid, drop, prec=FLOAT32):
        b, t, d = x.shape
        experts, k, hidden = self.gate.shape[1], self.top_k, self.w1.shape[-1]
        xs = x.reshape(b * t, d)
        logits = xs.float() @ self.gate
        top, chosen = torch.sort(logits, stable=True, dim=-1, descending=True)
        weights = torch.softmax(top[:, :k], -1)
        chosen = torch.where(valid.reshape(-1, 1), chosen[:, :k], experts)
        h = xs.new_zeros(b * t, k, hidden)
        routed = [torch.where(chosen == e) for e in range(experts)]
        for e, (token, slot) in enumerate(routed):
            if not len(token):  # an expert that receives nothing
                continue
            h = h.index_put((token, slot), ref.swish(prec.matmul(xs[token], self.w1[e])
                                                     + self.b1[e]))
        h = drop(h.view(b, t, k, hidden)).view(b * t, k, hidden)
        y = xs.new_zeros(b * t, d)
        for e, (token, slot) in enumerate(routed):
            if not len(token):
                continue
            out = prec.matmul(h[token, slot], self.w2[e]) + self.b2[e]
            y = y.index_add(0, token, weights[token, slot, None] * out)
        return y.view(b, t, d)


class EncoderLayer(ref.EncoderLayer):
    """:class:`.conformer.EncoderLayer` with MoE FFNs: the final one, and
    the macaron one with ``macaron``."""

    def __init__(self, d, h, ffn, kernel, experts, top_k, macaron):
        super().__init__(d, h, ffn, kernel)
        if macaron:
            self.feed_forward_macaron = MoE(d, ffn, experts, top_k)
        self.feed_forward = MoE(d, ffn, experts, top_k)

    def forward(self, x, mask, pos, drop, prec):
        valid = mask[:, 0]

        def ffn(module, y):
            if isinstance(module, MoE):
                return module(y, valid, drop, prec)
            return module(y, ref.swish, drop, prec)

        x = x + 0.5 * drop(ffn(self.feed_forward_macaron,
                               ref.layer_norm(x, self.norm_ff_macaron)))
        y = ref.layer_norm(x, self.norm_mha)
        x = x + drop(self.self_attn(y, y, mask, prec, pos=pos))
        x = x + drop(self.conv_module(ref.layer_norm(x, self.norm_conv), valid, prec))
        x = x + 0.5 * drop(ffn(self.feed_forward, ref.layer_norm(x, self.norm_ff)))
        return ref.layer_norm(x, self.norm_final)


class ConformerMoE(ref.Conformer):
    """:class:`.conformer.Conformer` whose encoder blocks take ``moe_experts``
    experts with top ``moe_top_k`` in the final FFN and, with
    ``moe_macaron``, the macaron FFN; dropless only
    (``moe_capacity_factor`` None)."""

    def __init__(self, vocab_size, moe_experts=0, moe_top_k=2, moe_macaron=False,
                 moe_capacity_factor=None, d_model=256, head_num=4, ffn_dim=2048,
                 num_encoder_layers=12, kernel_size=15, **kw):
        super().__init__(vocab_size, d_model=d_model, head_num=head_num, ffn_dim=ffn_dim,
                         num_encoder_layers=num_encoder_layers, kernel_size=kernel_size, **kw)
        if moe_capacity_factor is not None:
            raise ValueError("the reference MoE is dropless: moe_capacity_factor must be None")
        if moe_experts:
            self.encoder.layers = nn.ModuleList(
                EncoderLayer(d_model, head_num, ffn_dim, kernel_size, moe_experts, moe_top_k,
                             moe_macaron) for _ in range(num_encoder_layers))

    def init_spec(self):
        """:meth:`.conformer.Conformer.init_spec` with the experts' leaves:
        the router and each expert's matrices ``N(0, 1 / fan_in)`` with the
        fan-in of one expert's matrix, their biases zero."""
        out = []
        for name, shape, kind, fan_in in super().init_spec():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("b1", "b2"):
                kind, fan_in = "zeros", 0
            elif leaf == "gate":
                fan_in = shape[0]
            elif leaf in ("w1", "w2"):
                fan_in = shape[1]
            out.append((name, shape, kind, fan_in))
        return out
