"""The port's pure-Python Flax msgpack codec (`utils/flax_msgpack.py`)
against `flax.serialization`: random trees (Hypothesis) of nested dicts
with str and int-like str keys, Python ints, floats, bools, None and
strings, numpy arrays of f32/f64/int32/int64/bool/bf16 from 0-d to 3-d and
numpy scalars.  Each tree serializes to Flax's bytes, and each side
restores the other's bytes to the tree (array dtypes, shapes and bytes
equal; bf16 arrays come back from the port as torch.bfloat16 tensors).
The chunked form of oversized arrays is checked at a small
`MAX_CHUNK_SIZE`, patched on both modules in the test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, Phase, given, settings
from hypothesis import strategies as st

from r3dfsseg_tpu_torch.utils import flax_msgpack

# no example database and no explain phase: the test writes nothing to disk
SETTINGS = settings(max_examples=60, deadline=None, database=None,
                    phases=[Phase.explicit, Phase.generate, Phase.shrink],
                    suppress_health_check=[HealthCheck.too_slow])
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.bool_, jnp.bfloat16]


@st.composite
def arrays(draw):
    dtype = draw(st.sampled_from(DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    if dtype is np.bool_:
        a = rng.integers(0, 2, size=shape).astype(bool)
    elif dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)
    else:
        a = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4)).astype(dtype)
    return np.asarray(a)


scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.builds(lambda v: np.float32(v), st.floats(-1e6, 1e6, width=32)),
    st.builds(np.int64, st.integers(-2**63, 2**63 - 1)),
    st.builds(lambda v: np.asarray(v, jnp.bfloat16)[()], st.floats(-1e3, 1e3, width=32)))
leaves = st.one_of(scalars, arrays())
keys = st.one_of(st.text(max_size=12), st.integers(0, 300).map(str))
trees = st.recursive(leaves, lambda sub: st.dictionaries(keys, sub, max_size=5), max_leaves=12)


def _bits(a) -> tuple:
    """(dtype name, shape, bytes) of an array, a scalar or a bf16 tensor."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return "bfloat16", tuple(a.shape), a.view(torch.uint16).numpy().tobytes()
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic, torch.Tensor)):
        assert isinstance(got, (np.ndarray, np.generic, torch.Tensor)), (path, type(got))
        if not isinstance(want, torch.Tensor):
            assert isinstance(got, np.generic) == isinstance(want, np.generic), path
        assert _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _sorted(tree):
    """The tree as both sides restore it: maps in sorted key order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _as_port(tree):
    """The tree as the port restores it: bf16 arrays and scalars as torch
    tensors."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(tree).view(np.uint16).copy()).view(torch.bfloat16)
    return tree


@SETTINGS
@given(trees)
def test_port_bytes_are_flax_bytes_and_restore_both_ways(tree):
    got = flax_msgpack.msgpack_serialize(tree)
    assert got == serialization.msgpack_serialize(tree)
    assert_same(serialization.msgpack_restore(got), _sorted(tree))
    assert_same(flax_msgpack.msgpack_restore(serialization.msgpack_serialize(tree)),
                _as_port(_sorted(tree)))


@SETTINGS
@given(st.dictionaries(keys, arrays(), min_size=1, max_size=4))
def test_bf16_tensors_write_as_flax_bf16(tree):
    """A torch bf16 tensor leaf writes the bytes of the same bits as a JAX
    bf16 array, and the port reads both back as tensors."""
    port = _as_port(tree)
    data = flax_msgpack.msgpack_serialize(port)
    assert data == serialization.msgpack_serialize(tree)
    assert_same(flax_msgpack.msgpack_restore(data), _as_port(_sorted(tree)))


@pytest.mark.parametrize("chunk", [16, 40, 1000])
def test_chunked_arrays_read_and_write_as_flax(monkeypatch, chunk):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(chunk)
    tree = {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "layer": {"k": rng.integers(0, 9, size=(3, 4, 5)).astype(np.int64),
                      "small": np.float32([1.0, 2.0]),
                      "bf": np.asarray(rng.normal(size=(33,)), jnp.bfloat16)}}
    data = flax_msgpack.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    if chunk < 1000:
        assert b"__msgpack_chunked_array__" in data
    assert_same(serialization.msgpack_restore(data), _sorted(tree))
    assert_same(flax_msgpack.msgpack_restore(data), _as_port(_sorted(tree)))
    # a whole tree that is one oversized array
    a = rng.normal(size=(6, 6)).astype(np.float64)
    assert flax_msgpack.msgpack_serialize(a) == serialization.msgpack_serialize(a)
    np.testing.assert_array_equal(flax_msgpack.msgpack_restore(flax_msgpack.msgpack_serialize(a)),
                                  a)


def test_unknown_ext_and_types_raise():
    with pytest.raises(TypeError, match="unknown ext type 5"):
        flax_msgpack.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(TypeError, match="complex"):
        flax_msgpack.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(TypeError, match="builtins.set"):
        flax_msgpack.msgpack_serialize({"s": {1, 2}})
    with pytest.raises(TypeError, match="builtins.object"):
        flax_msgpack.msgpack_serialize([object()])
    with pytest.raises(ValueError, match="unknown type byte 0xc1"):
        flax_msgpack.msgpack_restore(b"\xc1")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(serialization.msgpack_serialize({"a": np.zeros(4)})[:-3])
