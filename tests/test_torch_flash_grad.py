"""The port's flash-attention gradient on the CPU (``FlashAttentionFn``
with its plain forward and backward) against ``jax.vjp`` of the JAX
package's blocked flash attention (its flash backward, ``_make_blocked_vjp``),
on the same seeded numpy inputs: causal, sliding window, length (rows past
the length), full, q_offset, GQA groups of 1 and more, and Sk not a
multiple of the JAX key block.  Float32, held at 2e-5 of each gradient's
largest magnitude (test_kernels.py's float32 tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tensors here are small: one intra-op thread, so that a
    parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (b, h, kh, sq, sk, d, mode, window, q_offset, lengths, block_k)
CASES = {
    "causal_gqa2": (2, 4, 2, 64, 64, 32, "causal", 0, 0, None, 256),
    "causal_window": (1, 4, 1, 80, 80, 32, "causal", 16, 0, None, 32),
    "causal_offset": (2, 4, 4, 20, 100, 32, "causal", 0, 80, None, 64),
    "length": (2, 4, 2, 24, 100, 32, "length", 0, 0, (37, 100), 64),
    "length_window": (2, 2, 2, 8, 70, 64, "length", 8, 0, (5, 61), 32),
    "full_ragged": (2, 2, 1, 33, 70, 64, "full", 0, 0, None, 64),
    "causal_d96": (1, 6, 2, 40, 40, 96, "causal", 0, 0, None, 16),
}


def inputs(case, seed=0):
    b, h, kh, sq, sk, d, *_ = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kh, sk, d).astype(np.float32)
    v = rng.randn(b, kh, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, do


def scaled_close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def jax_vjp(case, q, k, v, do):
    _, _, _, _, sk, _, mode, window, q_offset, lengths, block_k = CASES[case]
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def f(q, k, v):
        return jops.flash_attention(q, k, v, mode=mode, window=window,
                                    lengths=lens, q_offset=q_offset,
                                    impl="blocked", block_k=block_k)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def port_grads(case, q, k, v, do):
    _, _, _, _, _, _, mode, window, q_offset, lengths, _ = CASES[case]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    out = fa_ops.flash_attention(qt, kt, vt, mode=mode, window=window,
                                 lengths=lens, q_offset=q_offset)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    return out, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grad_matches_jax_vjp(case):
    q, k, v, do = inputs(case)
    jout, jgrads = jax_vjp(case, q, k, v, do)
    out, grads = port_grads(case, q, k, v, do)
    scaled_close(out, jout, f"{case}: out")
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        scaled_close(got, want, f"{case}: {name}")


@pytest.mark.parametrize("case", ["causal_window", "length", "full_ragged"])
def test_lse_matches_the_jax_forward_pass(case):
    b, h, kh, sq, sk, d, mode, window, q_offset, lengths, block_k = \
        CASES[case]
    q, k, v, _ = inputs(case, seed=1)
    lens = jnp.asarray(lengths if lengths is not None else (sk,) * b,
                       jnp.int32)
    _, jlse = jops._blocked_fwd_pass(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode=mode,
        window=window, lengths=lens, q_offset=q_offset, scale=None,
        block_k=block_k)
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    _, lse = fa_ref.attention_reference_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mode=mode, window=window, lengths=tl, q_offset=q_offset)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(b, h, sq),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["causal_gqa2", "length_window"])
def test_plain_backward_is_the_gradient_of_the_plain_forward(case):
    """Autograd through ``attention_reference`` gives the plain backward's
    gradients wherever every row sees a key (both float32 inside, so at
    the float32 tolerance)."""
    _, _, _, _, _, _, mode, window, q_offset, lengths, _ = CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in inputs(case, 2))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    kw = dict(mode=mode, window=window, lengths=lens, q_offset=q_offset)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa_ref.attention_reference(qa, ka, va, **kw).backward(do)
    out, lse = fa_ref.attention_reference_lse(q, k, v, **kw)
    grads = fa_ref.attention_backward_reference(q, k, v, out, lse, do, **kw)
    for name, got, t in zip(("dq", "dk", "dv"), grads, (qa, ka, va)):
        scaled_close(got, t.grad.numpy(), f"{case}: {name}")


def test_a_row_that_sees_no_key_has_no_gradient():
    """Causal, window 4, Sq past Sk: rows 11.. see no key.  Their lse is
    -1e30 and their gradient 0 (the kernels give them output 0); the rows
    that see keys keep their gradient."""
    rng = np.random.RandomState(4)
    q, do = (torch.from_numpy(rng.randn(1, 2, 16, 32).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 1, 8, 32).astype(np.float32))
            for _ in range(2))
    kw = dict(mode="causal", window=4)
    out, lse = fa_ref.attention_reference_lse(q, k, v, **kw)
    assert (lse[:, :, 11:] == -1e30).all() and (lse[:, :, :11] > -1e3).all()
    dq, dk, dv = fa_ref.attention_backward_reference(q, k, v, out, lse, do,
                                                     **kw)
    assert (dq[:, :, 11:] == 0).all() and (dq[:, :, :11] != 0).any()
    assert (dk != 0).any() and (dv != 0).any()


def test_without_grad_the_forward_runs_alone():
    q, k, v, _ = (torch.from_numpy(x) for x in inputs("causal_gqa2"))
    out = fa_ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa_ref.attention_reference(q, k, v),
                               rtol=0, atol=0)
    with torch.no_grad():
        out = fa_ops.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None


def test_refuse_grad_names_the_missing_backward():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError,
                       match="decode-attention.*no backward kernel"):
        _build.refuse_grad("the decode-attention kernels", x)
    with torch.no_grad():
        _build.refuse_grad("the decode-attention kernels", x)
    _build.refuse_grad("the decode-attention kernels", x.detach())
