"""Helpers of the port's parity tests: the same numpy inputs and weights go
through a ``cfpnet_tpu`` module (on the CPU, in float64 where asked) and its
``cfpnet_torch`` counterpart."""

from contextlib import contextmanager

import jax
import numpy as np
import torch

from cfpnet_torch import weights

# torch's CPU exp, log, sqrt, tanh, ... call MKL's vector math library (VML)
# on chunks of 2048 elements and more, one chunk a thread. The first such
# call in a process, made from several threads at once, now and then
# returns one thread's chunk at about 1e-4 relative error (a race in VML's
# set-up on its first use; seen under heavy load of the machine, in about one
# process of a hundred). One call of each function on one element, on this
# thread, sets VML up before any parallel call.
VML_FUNCTIONS = (torch.acos, torch.asin, torch.atan, torch.cos, torch.erf, torch.erfc,
                 torch.erfinv, torch.exp, torch.log, torch.log10, torch.log2, torch.sin,
                 torch.sqrt, torch.tan, torch.tanh, torch.trunc)
for _dtype in (torch.float32, torch.float64):
    for _fn in VML_FUNCTIONS:
        _fn(torch.full((1,), 0.5, dtype=_dtype))

# The tests run tiny models, whose ops are too small to share among threads:
# at torch's default of one thread a core a tiny training run took 3 times as
# long on an idle 8-core machine as with one thread, and a test run's
# workers share the cores besides. One thread a process.
torch.set_num_threads(1)


@contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def random_tree(shapes, seed: int, kernel_std: float = 0.15, dtype=np.float64):
    """Well-scaled random leaves for a flax variable tree of shapes: BN
    variances in [0.5, 1.5], scales near 1, small kernels and biases."""
    rng = np.random.default_rng(seed)

    def mk(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        shape = leaf.shape
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = 0.3 * rng.standard_normal(shape)
        elif name == "scale":
            v = rng.uniform(0.9, 1.1, shape)
        elif name.startswith("positional_encodings"):
            v = 0.2 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.05 * rng.standard_normal(shape)
        else:
            v = kernel_std * rng.standard_normal(shape)
        return np.asarray(v, dtype)

    return jax.tree_util.tree_map_with_path(mk, shapes)


def state_dict(entries, params, batch_stats=None):
    """Port state_dict of a submodule from flax trees, through the bridge's
    own entry tables: ``entries`` is [(torch key, flax path, kind,
    collection)]."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    out = {}
    for tkey, fpath, kind, col in entries:
        node = trees[col]
        for p in fpath:
            node = node[p]
        out[tkey] = torch.from_numpy(np.ascontiguousarray(
            weights._to_torch_layout(np.asarray(node), kind)))
    return out


def table_entries(table, key_prefix="", path_prefix=()):
    """[(key, path, kind, col)] of a name-map table, keeping keys that start
    with ``key_prefix`` (stripped) and dropping ``path_prefix`` from paths."""
    n = len(path_prefix)
    return [(k[len(key_prefix):], fp[n:], kind, col) for k, (fp, kind, col) in table.items()
            if k.startswith(key_prefix)]


def load(module, entries, params, batch_stats=None):
    """``module`` in float64 and eval mode, carrying the flax weights."""
    module = module.double().eval()
    module.load_state_dict(state_dict(entries, params, batch_stats), strict=True)
    return module


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, ref, rtol=1e-7, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)
