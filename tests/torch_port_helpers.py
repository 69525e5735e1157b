"""Shared helpers of the `test_torch_*.py` files (the PyTorch port held
against the JAX reference).

Importing this module pins torch to one intra-op thread: the tests run
many small eager CPU ops, and under pytest-xdist six workers each
spinning a full thread pool oversubscribe the cores many times over.
"""
import jax
import numpy as np
import torch

from repro.core import nsga2 as rnsga2
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.core import nsga2 as tnsga2

torch.set_num_threads(1)


def port_space(cfgs) -> tnsga2.SpaceOperands:
    """The reference's `SpaceOperands` of `cfgs`, stacked and carried
    into the port through `convert`."""
    spaces = [rnsga2.space_operands(c) for c in cfgs]
    return convert.space_operands_from_numpy({
        "array_size": np.stack([np.asarray(s.array_size) for s in spaces]),
        "gene_lo": np.stack([np.asarray(s.gene_lo) for s in spaces]),
        "gene_hi": np.stack([np.asarray(s.gene_hi) for s in spaces]),
        "cal": {k: np.stack([np.asarray(getattr(s.cal, k)) for s in spaces])
                for k in spaces[0].cal._fields}})


class JaxDraws:
    """Draw source for the port's NSGA-II operators that makes every
    random number with `jax.random` under the reference's key splits
    (`run_cell`: key -> (kinit, kgen); per generation kgen -> (kgen,
    sub); sub -> (ksel, kvar); kvar -> (kx, kswap, kmut, kval))."""

    def __init__(self, keys):
        self.kinit, self.kgen = [], []
        for k in keys:
            a, b = jax.random.split(k)
            self.kinit.append(a)
            self.kgen.append(b)

    @classmethod
    def from_generation_keys(cls, keys) -> "JaxDraws":
        """A source whose generation keys are `keys` themselves:
        `evolve_from(key, ...)` splits its key per generation as `run_cell`
        splits its `kgen`, and makes no initial population."""
        draws = cls([])
        draws.kgen = list(keys)
        return draws

    def init(self, lo, hi, pop):
        out = []
        for c, k in enumerate(self.kinit):
            cols = [jax.random.randint(kk, (pop,), int(lo[c, i]),
                                       int(hi[c, i]) + 1)
                    for i, kk in enumerate(jax.random.split(k, 3))]
            out.append(np.stack([np.asarray(x) for x in cols], 1))
        return torch.tensor(np.stack(out), dtype=torch.int32)

    @staticmethod
    def step(subs, n, p, statics) -> tnsga2.GenerationDraws:
        """One generation's draws from each cell's generation key."""
        parts = []
        for sub in subs:
            ksel, kvar = jax.random.split(sub)
            kx, kswap, kmut, kval = jax.random.split(kvar, 4)
            parts.append([np.asarray(x) for x in (
                jax.random.randint(ksel, (n, 2), 0, p),
                jax.random.bernoulli(kx, statics.crossover_prob, (p, 1)),
                jax.random.bernoulli(kswap, 0.5, (p, 3)),
                jax.random.uniform(kval, (p, 3)),
                jax.random.bernoulli(kmut, statics.mutation_prob, (p, 3)))])
        pairs, do_cx, swap, u, mut = (np.stack(x) for x in zip(*parts))
        return tnsga2.GenerationDraws(
            torch.from_numpy(pairs).long(), torch.from_numpy(do_cx),
            torch.from_numpy(swap), torch.from_numpy(u),
            torch.from_numpy(mut))

    def generation(self, n, p, statics):
        subs = []
        for c in range(len(self.kgen)):
            self.kgen[c], sub = jax.random.split(self.kgen[c])
            subs.append(sub)
        return self.step(subs, n, p, statics)

    def generations(self, n_gens, n, p, statics):
        """Every generation's draws stacked on a leading G axis, by the same
        `generation` calls in the same order as the composite loop."""
        return tnsga2.stack_generations(
            [self.generation(n, p, statics) for _ in range(n_gens)],
            len(self.kgen), n, p, "cpu")


class JaxGumbel:
    """The reference engine's noise: per sampled token `key, sub =
    split(key)`, then `jax.random.gumbel(sub, (V,))`, which
    `jax.random.categorical(sub, z)` adds to z before its argmax; a
    `noise` source for the port's `ServeEngine`."""

    def __init__(self, seed: int):
        self.key = jax.random.key(seed)

    def __call__(self, n: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.gumbel(sub, (n,),
                                                         jax.numpy.float32)))


def ref_train_step(loss_fn, rp, ropt, batch, microbatches, opt_cfg,
                   jit: bool = False):
    """The reference's train step unjitted (its jitted `make_train_step`
    raises `ShardingTypeError` on this JAX): `value_and_grad(loss_fn)`
    over its microbatch loop (grads summed from zero in float32 and
    divided by the count, loss the mean), then `adamw.update`.  With
    `jit`, `value_and_grad(loss_fn)` alone is jitted (one compile in
    place of many eager ones).  Returns (new params, new AdamW state,
    AdamW's metrics with `loss`)."""
    vg = jax.value_and_grad(loss_fn, has_aux=True)
    if jit:
        vg = jax.jit(vg)
    batch = jax.tree.map(jax.numpy.asarray, batch)
    if microbatches == 1:
        (loss, _), grads = vg(rp, batch)
    else:
        per = batch["inputs"].shape[0] // microbatches
        gacc = jax.tree.map(lambda p: jax.numpy.zeros(p.shape,
                                                      jax.numpy.float32), rp)
        lacc = 0.0
        for i in range(microbatches):
            mb = jax.tree.map(lambda a: a[i * per:(i + 1) * per], batch)
            (l, _), g = vg(rp, mb)
            gacc = jax.tree.map(lambda a, b: a + b.astype(jax.numpy.float32),
                                gacc, g)
            lacc = lacc + l
        grads = jax.tree.map(lambda g: g / microbatches, gacc)
        loss = lacc / microbatches
    new_p, new_opt, met = radamw.update(grads, ropt, rp, opt_cfg)
    return new_p, new_opt, dict(met, loss=loss)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| of two numpy arrays."""
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def leaves(tree) -> dict:
    """{keystr: numpy leaf} of a nested dict."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(tree, suffixes: tuple, seed: int):
    """`tree` with every leaf whose key path ends in one of `suffixes`
    moved off its initial value by 0.1 x standard normal numpy draws."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + jax.numpy.asarray(0.1 * rng.standard_normal(
            a.shape).astype(np.float32))
        if jax.tree_util.keystr(path).endswith(suffixes) else a, tree)


def serving_tree(tree):
    """The reference's `_to_serving_dtype` rule on a stacked tree: float32
    leaves of rank >= 2 to bf16."""
    return jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16)
                        if a.dtype == jax.numpy.float32 and a.ndim >= 2
                        else a, tree)


class F32Jnp:
    """`jax.numpy` with `bfloat16` read as float32: the reference's model
    modules cast the backbone with `astype(jnp.bfloat16)`."""
    bfloat16 = jax.numpy.float32

    def __getattr__(self, name):
        return getattr(jax.numpy, name)
