"""Sequence parallelism at sp = 2: the port against the JAX package.

JAX: ``parallel/sequence.py``'s ``ulysses_attention`` and ``ring_attention``
(plain, and the flash ring on its ``_jnp_block`` versions) inside
``shard_map`` over 2 devices of the ``hvd`` axis, as ``tests/
test_sequence.py`` runs them, with the gradients of sum(o^2); its
``next_token_labels`` over the axis. Port: one 2-process gloo world over an
``hvd`` DeviceMesh, the same functions (the flash ring through
``fa_forward``/``fa_backward``'s plain versions on the CPU), each rank on
its token shard.

Tolerances (fp32): outputs rtol 2e-4 / atol 2e-5, as JAX's tests hold the
schemes against full attention; gradients rtol 2e-3 / atol 2e-4, as JAX's
``test_ring_vjp_matches_plain_ring_grads`` holds the flash ring's against
the plain ring's. Labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_parallel_helpers as ph
import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.ops.pallas import flash_attention as jflash
from horovod_tpu.parallel import sequence as jsq

SP = 2
B, L, D = 2, 32, 16
# name -> (impl, causal, flash, query heads, kv heads): MHA; grouped K/V
# that rotate and exchange narrow (kv 2 divides sp); and Ulysses' grouped
# K/V broadcast before the exchange (kv 1 does not divide sp).
_SCHEMES = {"ring": ("ring", False, 4, 4),
            "ring_flash": ("ring", True, 4, 4),
            "ulysses": ("ulysses", False, 4, 4),
            "ulysses_flash": ("ulysses", True, 4, 4),
            "ring_gqa": ("ring", False, 8, 2),
            "ring_flash_gqa": ("ring", True, 8, 2),
            "ulysses_gqa": ("ulysses", False, 8, 2),
            "ulysses_gqa1": ("ulysses", False, 8, 1)}
CASES = {f"{name}_{'causal' if causal else 'full'}":
         (impl, causal, flash, h, kv)
         for name, (impl, flash, h, kv) in _SCHEMES.items()
         for causal in (False, True)}


def _inputs(seed, H, KV):
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(rng.standard_normal((B, L, h, D)), np.float32)
                 for h in (H, KV, KV))


def _jax_run(impl, causal, flash, q, k, v):
    mesh = Mesh(np.array(jax.devices()[:SP]), ("hvd",))
    spec = P(None, "hvd", None, None)
    fn = jsq.ring_attention if impl == "ring" else jsq.ulysses_attention

    def local(a, b, c):
        def loss(a, b, c):
            o = fn(a, b, c, causal=causal, use_flash=flash)
            return jnp.sum(o.astype(jnp.float32) ** 2), o
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(a, b, c)
        return (o,) + g

    out = jax.jit(jax.shard_map(local, mesh=mesh,
                                in_specs=(spec, spec, spec),
                                out_specs=(spec,) * 4))(q, k, v)
    return [np.asarray(t) for t in out]


@pytest.fixture(scope="module")
def data():
    inputs = {name: _inputs(i, H, KV)
              for i, (name, (_, _, _, H, KV)) in enumerate(CASES.items())}
    ids = np.arange(2 * 16, dtype=np.int64).reshape(2, 16)
    cases = {name: CASES[name][:3] + inputs[name] for name in CASES}
    return inputs, ids, cases


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX reference and the port's world, once for the whole run
    (``torch_shared.shared``); the world runs while JAX computes."""
    def compute():
        inputs, ids, cases = data
        port = helpers.run_world_async(ph.sp_world, SP, args=(cases, ids))
        ref = {name: _jax_run(*CASES[name][:3], *inputs[name])
               for name in CASES}
        mesh = Mesh(np.array(jax.devices()[:SP]), ("hvd",))
        ref["labels"] = np.asarray(jax.jit(jax.shard_map(
            lambda t: jsq.next_token_labels(t, axis_name="hvd"), mesh=mesh,
            in_specs=P(None, "hvd"), out_specs=P(None, "hvd")))(
                jnp.asarray(ids, jnp.int32)))
        return ref, port.result()
    return shared(tmp_path_factory, "sequence_runs", compute)


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def _joined(port, name, i):
    return np.concatenate([port[r][name][i] for r in range(SP)], axis=1)


@pytest.mark.parametrize("name", list(CASES))
def test_output_matches_jax(jax_ref, port, name):
    np.testing.assert_allclose(_joined(port, name, 0), jax_ref[name][0],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(jax_ref, port, name):
    for i, what in ((1, "dq"), (2, "dk"), (3, "dv")):
        np.testing.assert_allclose(_joined(port, name, i), jax_ref[name][i],
                                   rtol=2e-3, atol=2e-4,
                                   err_msg=f"{name} {what}")


def test_narrow_kv_keeps_narrow_gradients(port):
    """Grouped K/V rotate (and exchange) narrow: their gradients come back
    with the kv heads' shape."""
    for name in CASES:
        if CASES[name][4] < CASES[name][3]:
            assert port[0][name][2].shape[2] == CASES[name][4], name


def test_next_token_labels_over_the_axis(data, jax_ref, port):
    _, ids, _ = data
    got = np.concatenate([port[r]["labels"] for r in range(SP)], axis=1)
    np.testing.assert_array_equal(got, jax_ref["labels"])
    np.testing.assert_array_equal(
        got, np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1))


def test_unsharded_fallback_outside_the_axis(data, port):
    """Outside the axis both schemes are local attention, flash or not,
    and the labels the plain shift (JAX's behaviour outside shard_map)."""
    inputs, ids, _ = data
    name = next(iter(CASES))
    impl, causal, _, _, _ = CASES[name]
    q, k, v = (jnp.asarray(t) for t in inputs[name])
    want = {False: np.asarray(jsq.local_attention(q, k, v, causal=causal)),
            True: np.asarray(jflash(q, k, v,
                                       causal=causal))}
    for key, got in port[0]["fallback"].items():
        fl = key.endswith("True")
        np.testing.assert_allclose(got, want[fl], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(
        port[0]["fallback_labels"],
        np.asarray(jsq.next_token_labels(jnp.asarray(ids, jnp.int32))))


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_schedule_of_virtual_ranks_matches_full_attention(causal,
                                                               heads):
    """The flash ring's schedule (``ring_flash_forward``/``_backward``) for
    4 virtual ranks in one process (``sequence.rotate``, as ``chip_smoke.py``
    drives it on the card) against JAX's ``local_attention`` over the whole
    sequence and its VJP, at this file's tolerances; narrow K/V and
    gradients under GQA. The backward against each hop's own lse in place
    of the ring-wide one is far outside them."""
    import torch

    from horovod_tpu_torch.ops.kernels.flash_attention import _from3, _to3
    from horovod_tpu_torch.parallel import sequence as sq

    n, (H, KV) = 4, heads
    q, k, v = _inputs(11, H, KV)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jsq.local_attention(
        a, b, c, causal=causal), *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    def shards(t):
        return list(_to3(torch.from_numpy(t)).chunk(n, dim=1))
    qs, ks, vs, dos = (shards(t) for t in (q, k, v, do))
    gqa = (H, KV) if KV != H else (None, None)
    ranks, scale = list(range(n)), D ** -0.5
    outs, hops = sq.ring_flash_forward(qs, ks, vs, ranks, n, causal, scale,
                                       sq.rotate, *gqa)
    assert hops == ([r + 1 for r in ranks] if causal else [n] * n)

    def backward(hop_backward=None):
        grads = sq.ring_flash_backward(
            qs, ks, vs, [o for o, _ in outs], [lse for _, lse in outs], dos,
            ranks, n, causal, scale, sq.rotate, *gqa,
            hop_backward=hop_backward)
        return [_from3(torch.cat(g, dim=1), B, h).numpy()
                for g, h in zip(grads, (H, KV, KV))]
    got = _from3(torch.cat([o for o, _ in outs], dim=1), B, H).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
    for g, w, what in zip(backward(), want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-3, atol=2e-4,
                                   err_msg=what)

    def own_lse(q3, k3, v3, o3, lse, do3, diag, scale, *h):
        own = sq.ring_hop_forward(q3, k3, v3, diag, scale, *h)[1]
        return sq.ring_hop_backward(q3, k3, v3, o3, own, do3, diag, scale,
                                    *h)
    for g, w in zip(backward(own_lse), want_grads):
        assert np.abs(g - np.asarray(w)).max() > 100 * 2e-4
