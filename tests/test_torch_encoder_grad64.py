"""The dense Conformer encoder's gradients against JAX's, in float64.

In float32 the port's and JAX's encoders differ by about 12 % of a leaf's
largest gradient on some leaves of ``sum(out^2 * valid)`` (the subsampling
convs, the position biases). That loss sums the squares of a layer-normed
output, which are nearly constant, so its gradients are small differences
of large terms: float32 rounding, summed in another order on each side, is
enough to move them. In float64 the two agree to rounding, which shows the
float32 gap is the loss's conditioning and not a fault of the port.

JAX computes in a child process started with ``JAX_ENABLE_X64=1`` (x64 must
not leak into the other tests of the worker): the parameters are drawn as
``tests/test_torch_parallel_sp.py`` draws them (its config and inputs), cast
to float64, and the encoder runs with ``dtype=float64``. The port computes
in float64 here on the same parameters, carried across by
``convert_params(dtype=np.float64)``, as are JAX's gradients.

- Every leaf: within 1e-5 of the largest magnitude of JAX's gradient of that
  leaf.
- The key and position-projection biases, whose exact gradient is zero (a
  bias added to every key shifts every score of a row alike, and softmax
  ignores it): at most 1e-12 of the tree's largest gradient on both sides.
- The loss: 1e-12 relative.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mindaudio_torch.convert import convert_params
from mindaudio_torch.models.conformer import ConformerEncoder

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the config and inputs of tests/test_torch_parallel_sp.py
ENC = dict(input_dim=40, d_model=64, head_num=4, ffn_dim=128, num_layers=2,
           dropout_rate=0.0, kernel_size=15)
LEAF_TOL = 1e-5
ZERO_TOL = 1e-12

_CHILD = r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from mindaudio_tpu.models.conformer import ConformerEncoder

assert jax.config.jax_enable_x64
cfg, out = json.loads(sys.argv[1]), sys.argv[2]
rng = np.random.default_rng(0)
xs = rng.standard_normal((2, 131, 40)).astype(np.float32)
lens = np.array([131, 103], np.int32)
params = ConformerEncoder(**cfg).init(jax.random.PRNGKey(0), jnp.asarray(xs),
                                      jnp.asarray(lens))["params"]
params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
enc = ConformerEncoder(**cfg, dtype=jnp.float64)

def loss(p):
    out, mask = enc.apply({"params": p}, jnp.asarray(xs, jnp.float64), jnp.asarray(lens))
    return jnp.sum(jnp.square(out) * mask[:, 0, :, None])

value, grads = jax.jit(jax.value_and_grad(loss))(params)
flat = {}
for tag, tree in (("p", params), ("g", grads)):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        flat[tag + ":" + "/".join(k.key for k in path)] = np.asarray(leaf)
        assert flat[tag + ":" + "/".join(k.key for k in path)].dtype == np.float64
np.savez(out, loss=np.asarray(value), xs=xs, lens=lens, **flat)
"""


def _nest(flat, tag):
    tree = {}
    for key, leaf in flat.items():
        if key.startswith(tag + ":"):
            *scope, name = key[len(tag) + 1:].split("/")
            node = tree
            for s in scope:
                node = node.setdefault(s, {})
            node[name] = leaf
    return tree


def _zero_gradient(name):
    return name.endswith(("linear_k.bias", "linear_pos.bias"))


PORT_LEAVES = [n for n, _ in ConformerEncoder(**ENC).named_parameters()]


@pytest.fixture(scope="module")
def grads64(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad64") / "jax.npz"
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, (str(ROOT),
                                                        os.environ.get("PYTHONPATH")))))
    run = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(ENC), str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as f:
        flat = dict(f)
    enc = ConformerEncoder(**ENC).double().eval()
    enc.load_state_dict(convert_params(_nest(flat, "p"), dtype=np.float64), strict=True)
    assert all(p.dtype == torch.float64 for p in enc.parameters())
    xs = torch.from_numpy(flat["xs"]).double()
    out_, mask = enc(xs, torch.from_numpy(flat["lens"]).long())
    loss = (out_.square() * mask[:, 0, :, None]).sum()
    names, params = zip(*enc.named_parameters())
    got = dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, params))))
    want = {k: v.numpy() for k, v in
            convert_params(_nest(flat, "g"), dtype=np.float64).items()}
    return loss.item(), float(flat["loss"]), got, want


def test_the_leaves_are_the_same(grads64):
    _, _, got, want = grads64
    assert set(got) == set(want) == set(PORT_LEAVES)
    assert sum(map(_zero_gradient, got)) == 4


def test_loss_matches(grads64):
    got, want, _, _ = grads64
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("name", PORT_LEAVES)
def test_leaf_gradient_matches_jax_in_float64(grads64, name):
    _, _, got, want = grads64
    g, w = got[name], want[name]
    assert g.shape == w.shape and g.dtype == w.dtype == np.float64
    if _zero_gradient(name):
        scale = max(np.abs(v).max() for v in want.values())
        assert np.abs(g).max() <= ZERO_TOL * scale and np.abs(w).max() <= ZERO_TOL * scale
    else:
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= LEAF_TOL, f"{name}: {err:.3e} of its largest gradient"
