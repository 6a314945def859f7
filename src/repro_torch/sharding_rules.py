"""Parameter sharding rules shared by the launcher (the state's placements)
and the in-model FSDP unshard hint (``models/act_sharding.py``), the port
of ``repro.sharding_rules``: name-based FSDP + TP assignment with
divisibility-checked fallbacks.

The reference's ``PartitionSpec`` is JAX's; the port keeps its own
:class:`PartitionSpec`, a tuple with one entry per tensor dim (``None``,
a mesh axis name, or a tuple of axis names), and maps it onto a
``DeviceMesh``'s DTensor placements with :func:`placements`.

The reference scans its body over stacked period weights, so a ``body``
leaf there carries a leading layer dim that is never sharded.  The
port's body is a list of periods and its leaves have no such dim:
:func:`param_spec_for` gives such a leaf exactly the reference's spec
for the stacked leaf, with the stack dim's leading ``None`` dropped.
"""
from __future__ import annotations

# param name -> (tp_dim, fsdp_dim) on the UNSTACKED tensor, negative = from
# the end.  None entries mean "no preference".
RULES = {
    "e": (0, 1),           # embedding (V, D): vocab-parallel, FSDP on D
    "wq": (-1, 0), "wk": (-1, 0), "wv": (-1, 0),
    "wi": (-1, 0), "wg": (-1, 0), "wx": (-1, 0), "wa": (-1, 0),
    "router": (None, 0),
    "wo": (0, -1),
    "wf": (None, 0),
    "conv": (-1, None), "lam": (None, None), "g": (None, None),
    "rh": (-1, 1),
}
MOE_STACK = {"wi", "wg", "wo"}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of axis names (the dim split over each, major first).
    ``PartitionSpec(None, "model")`` as JAX's is written."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def param_spec_for(names: list, shape: tuple, axis_sizes: dict,
                   fsdp_axes: tuple = ("data",),
                   drop_fsdp: bool = False) -> PartitionSpec:
    """Infer the PartitionSpec for one parameter leaf.

    ``names``: the tree path keys as strings (last one is the param name).
    ``axis_sizes``: mesh axis name -> size.  ``drop_fsdp=True`` returns the
    spec with the FSDP axes removed (the unshard-at-use/FSDP-gather hint).
    A leaf under ``"body"`` is the port's, with no layer dim: its spec is
    the one the reference gives the stacked leaf, the layer dim's
    ``None`` dropped (the reference's rule takes some dims by index from
    the stacked shape, so it is applied to that shape).
    """
    names = [str(n) for n in names]
    if "body" in names:
        spec = _stacked_spec(names, (1,) + tuple(shape), axis_sizes,
                             fsdp_axes, drop_fsdp)
        return P(*spec[1:])
    return _stacked_spec(names, tuple(shape), axis_sizes, fsdp_axes,
                         drop_fsdp)


def _stacked_spec(names: list, shape: tuple, axis_sizes: dict,
                  fsdp_axes: tuple, drop_fsdp: bool) -> PartitionSpec:
    """The reference's rule, on its layout: a leaf under ``"body"`` carries
    the leading scanned layer dim."""
    name = names[-1]
    in_body = "body" in names
    in_moe = "ffn" in names and len(shape) - (1 if in_body else 0) == 3
    dims: list = [None] * len(shape)
    off = 1 if in_body else 0  # leading scanned layer dim stays unsharded
    model = axis_sizes.get("model", 1)
    fsdp = fsdp_axes[0] if len(fsdp_axes) == 1 else tuple(fsdp_axes)
    fsdp_size = 1
    for a in fsdp_axes:
        fsdp_size *= axis_sizes.get(a, 1)

    def try_set(dim, axis, size):
        if dim is None:
            return False
        d = dim if dim >= 0 else len(shape) + dim
        if d < off or d >= len(shape):
            return False
        if dims[d] is None and shape[d] % size == 0 and shape[d] >= size:
            dims[d] = axis
            return True
        return False

    if in_moe and name in MOE_STACK:
        # (E, D, F) or (E, F, D) (+ optional stack dim)
        if not try_set(off + 0, "model", model):   # expert-parallel
            try_set(-1 if name != "wo" else off + 1, "model", model)
        if not drop_fsdp:
            try_set(off + 1 if name != "wo" else -1, fsdp, fsdp_size)
        return P(*dims)

    tp_dim, fsdp_dim = RULES.get(name, (None, None))
    ok_tp = try_set(tp_dim if tp_dim is None or tp_dim >= 0
                    else len(shape) + tp_dim, "model", model)
    if not ok_tp and tp_dim is not None:
        for d in range(len(shape) - 1, off - 1, -1):
            if try_set(d, "model", model):
                break
    if fsdp_dim is not None and not drop_fsdp:
        if not try_set(fsdp_dim if fsdp_dim >= 0 else len(shape) + fsdp_dim,
                       fsdp, fsdp_size):
            for d in range(off, len(shape)):
                if try_set(d, fsdp, fsdp_size):
                    break
    return P(*dims)


def placements(spec, mesh) -> tuple:
    """``spec`` as the DTensor placements of ``mesh`` (a ``DeviceMesh``
    with ``mesh_dim_names``): ``Shard(d)`` on each mesh dim that the spec
    names at tensor dim ``d``, ``Replicate()`` on every other.

    A tuple entry such as ``("pod", "data")`` shards its tensor dim over
    both mesh dims, the first named the major one, which is the order
    GSPMD uses.  DTensor always splits a tensor dim over several mesh dims
    in the mesh's own order, so a tuple given in another order than the
    mesh's would lay the shards out differently; it raises here."""
    from torch.distributed.tensor import Replicate, Shard

    axes = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(axes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [axes.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {names} of dim {d} are not in the mesh's "
                             f"order {axes}; DTensor would order the shards "
                             f"by the mesh")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axes[i]!r} shards two dims "
                                 f"in {spec}")
            out[i] = Shard(d)
    return tuple(out)
