"""Label-family registry: one descriptor per prune family, consulted by
every lifecycle path.

A :class:`LabelFamily` declares what the lifecycle needs to know about a
family: its plane width and element type, the monoid of its fixpoint
(``"or"`` bit lanes, ``"min"`` interval ranks), its Alg-1 seed and build,
its Alg-3 insert hook, its rebuild hook, and its verdict contribution
(positive or negative) and what it contributes while the labels carry
un-rebuilt deletions.

``"dl"`` and ``"bl"`` are the fused core: their four planes share one OR
fixpoint and one verdict kernel, so their hooks stay ``None`` here and
``labels``/``update``/``query`` run them jointly.  Every index carries
them, first.  Plug-in families (``"il"``) carry real hooks and are
dispatched generically by ``dbl`` and ``serve.engine``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

#: The fused DL/BL core every index carries; ``resolve`` requires the
#: enabled-families tuple to start with exactly this prefix.
CORE_FAMILIES = ("dl", "bl")
DEFAULT_FAMILIES = CORE_FAMILIES

#: Default interval dimensions per direction for the "il" family.
DEFAULT_IL_DIM = 4

#: Plug-in family name -> module that registers it on import.
_PLUGIN_MODULES = {"il": "repro_torch.core.interval"}


@dataclass(frozen=True)
class LabelFamily:
    """Declarative descriptor of one label family.

    Hook signatures (plug-in families; ``None`` = fused DL/BL core):

    - ``seed_plane(n_cap, dim, seed, device) -> (n_cap, width) plane``
    - ``build(g, *, n_cap, dim, seed, max_iters) -> (in, out, iters)``
    - ``insert_update(g2, p_in, p_out, ns, nd, *, n_cap, max_iters)
      -> (in', out', iters)``, ``g2`` already holding the new edges
    - ``rebuild(g, *, n_cap, dim, seed, max_iters) -> (in, out, iters)``,
      the repair over the live edge set (delta and full rebuilds alike)
    - ``negative(rows...) -> (Q,) bool``, the negative-prune predicate on
      gathered query rows

    ``build`` and ``insert_update`` also take ``combine=`` (``propagate``'s
    edge-partitioned rounds, for ``core.distributed``'s auto-partitioned
    scheme).
    """
    name: str
    monoid: str           # "or" (bit lanes) | "min" (rank lanes)
    plane_dtype: str      # "uint8" | "int32"
    verdict: str          # "positive" | "negative"
    while_dirty: str      # "self-positive" | "negative" | "none"
    fused_core: bool = False
    packable: bool = False        # may ride plane_repr="packed"
    plane_width: Callable[[int], int] = staticmethod(lambda d: d)
    seed_plane: Callable | None = None
    build: Callable | None = None
    insert_update: Callable | None = None
    rebuild: Callable | None = None
    negative: Callable | None = None


_REGISTRY: dict[str, LabelFamily] = {}


def register(fam: LabelFamily) -> LabelFamily:
    """Idempotent by name (module reload / double import safe)."""
    _REGISTRY[fam.name] = fam
    return fam


def get(name: str) -> LabelFamily:
    if name not in _REGISTRY and name in _PLUGIN_MODULES:
        importlib.import_module(_PLUGIN_MODULES[name])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown label family {name!r}; registered: "
            f"{sorted(set(_REGISTRY) | set(_PLUGIN_MODULES))}") from None


def resolve(families) -> tuple[LabelFamily, ...]:
    """Validate and resolve an enabled-families tuple: the fused
    ``("dl", "bl")`` core first, then plug-in families, each at most
    once."""
    families = tuple(families)
    if families[:2] != CORE_FAMILIES:
        raise ValueError(
            f"families must start with {CORE_FAMILIES}, got {families!r}")
    if len(set(families)) != len(families):
        raise ValueError(f"duplicate family in {families!r}")
    return tuple(get(name) for name in families)


def plugins(families) -> tuple[LabelFamily, ...]:
    """The non-core (hook-dispatched) suffix of ``families``."""
    return resolve(families)[2:]


register(LabelFamily(
    name="dl", monoid="or", plane_dtype="uint8", verdict="positive",
    while_dirty="self-positive", fused_core=True, packable=True,
    plane_width=staticmethod(lambda k: k)))
register(LabelFamily(
    name="bl", monoid="or", plane_dtype="uint8", verdict="negative",
    while_dirty="negative", fused_core=True, packable=True,
    plane_width=staticmethod(lambda k_prime: k_prime)))
