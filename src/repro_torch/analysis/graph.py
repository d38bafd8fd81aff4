"""Graph analysis: collective sites, payload bytes and program costs of a
captured ``torch.fx`` graph.

The counterpart of the JAX package's ``analysis/hlo.py``, which parses
compiled XLA HLO text.  The port reads the graph ``make_fx`` records of
an eager program instead (``capture``): one node per ATen op, every
``torch.distributed`` collective included, whoever wrote the code that
issued it.  Two forms of collective appear:

* in-place c10d ops (``c10d.allreduce_``, ``c10d._allgather_base_``,
  ``c10d._reduce_scatter_base_``, ``c10d.alltoall_base_``, ``c10d.send``
  / ``c10d.recv_``), what ``dist.all_reduce`` and friends record, the
  process group a torchbind ``get_attr`` argument;
* functional collectives (``_c10d_functional.<op>``), each followed by
  the ``_c10d_functional.wait_tensor`` that hands its value on, the group
  named by a string.

Every site's class is normalised to the HLO class names
(``"all-gather"``, ..., ``"collective-permute"``; ``core.cell.HLO_TO_OP``)
so that the two packages' sites compare field by field.  The payload
follows the JAX package's convention: the summed bytes of the operands,
so an all-gather counts its shard and a reduce-scatter its full input.
The send and receive nodes of one ``batch_isend_irecv`` are one
``collective-permute`` site.

A functional collective is paired with its ``wait_tensor``: one whose
result is never waited on, or a ``wait_tensor`` of no collective, raises
``GraphParseError`` (the counterpart of ``hlo.py``'s "``-done`` with no
``-start``" rule: never a silent undercount).  An FX graph unrolls Python
loops, so no trip counts are needed (``mult`` is always 1); a
higher-order op that hides a body (``while_loop``, ``scan``, ``cond``,
``invoke_subgraph``) raises, naming it, rather than being skipped.
"""
from __future__ import annotations

import dataclasses
import operator
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry

from repro_torch.core.cell import dtype_name

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: in-place c10d op -> (class, index of the payload argument)
_INPLACE = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
    "reduce_": ("reduce", 0),
    "gather_": ("gather", 1),
    "scatter_": ("scatter", 1),
    "barrier": ("barrier", 0),
}
_P2P = ("send", "recv_")

#: functional collective -> class (the payload is argument 0)
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_WAIT = "wait_tensor"
_FUNCTIONAL_NS = ("_c10d_functional", "_c10d_functional_autograd")


class GraphParseError(ValueError):
    """The graph violates a parser invariant (an unwaited functional
    collective, a wait of no collective, a body hidden in a higher-order
    op): callers gating on "zero dropped sites" treat it as a hard
    failure, never as a silent undercount."""


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def capture(fn, *args, fake: bool = True) -> torch.fx.GraphModule:
    """The ATen graph of ``fn(*args)``, recorded by ``make_fx``.

    ``fake=True`` traces on fake tensors: real ``args`` are converted, and
    fake ones (``launch.shapes.local_args``) are used as they are, so a
    program of any size is captured without its memory.  Tensors the
    program makes or caches outside the trace become graph constants.
    ``fake=False`` runs the program while tracing it.  The graph's
    ``meta["world"]`` is the default process group's size (1 without
    one), what ``module_world`` reads."""
    from torch.fx.experimental.proxy_tensor import make_fx
    if fake:
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    else:
        gm = make_fx(fn)(*args)
    gm.meta["world"] = (dist.get_world_size() if dist.is_available()
                        and dist.is_initialized() else 1)
    return gm


def module_world(gm: torch.fx.GraphModule) -> int:
    """The process world the graph was captured in (``capture``)."""
    return int(gm.meta.get("world", 1))


# ---------------------------------------------------------------------------
# node helpers
# ---------------------------------------------------------------------------


def _ns_name(target) -> tuple[str, str]:
    """``(namespace, op name)`` of an ATen/c10d overload, else ("", "")."""
    pkt = getattr(target, "overloadpacket", None)
    if pkt is None:
        return "", ""
    qual = getattr(pkt, "_qualified_op_name", "")
    if "::" not in qual:
        return "", ""
    ns, name = qual.split("::", 1)
    return ns, name


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else x


def _tensors(v) -> list:
    return [t for t in pytree.tree_leaves(v) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_nodes(a) -> list[torch.fx.Node]:
    """The tensor-valued nodes in an argument (lists flattened)."""
    out = []
    for x in pytree.tree_leaves(a):
        if isinstance(x, torch.fx.Node) and isinstance(_val(x),
                                                       torch.Tensor):
            out.append(x)
    return out


def _node_bytes(nodes) -> int:
    return sum(_nbytes(_val(n)) for n in nodes)


def _group_of(gm, node) -> "dist.ProcessGroup | None":
    """The process group a c10d node runs on: its torchbind ``get_attr``
    argument (in-place ops) or its group name (functional ops)."""
    for a in node.args:
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            if isinstance(obj, torch.ScriptObject):
                try:
                    return dist.ProcessGroup.unbox(obj)
                except RuntimeError:
                    continue
    names = [a for a in node.args if isinstance(a, str)]
    if names:
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(names[-1])
    return None


def _check_flat(gm) -> None:
    """Raise on a higher-order op: its body (and any collective in it) is
    not in this graph's node list."""
    for n in gm.graph.nodes:
        if n.op == "call_function" and isinstance(
                n.target, torch._ops.HigherOrderOperator):
            raise GraphParseError(
                f"higher-order op {n.target.__name__!r} at node {n.name!r} "
                "hides a body: its collectives and costs cannot be counted "
                "(capture the program with the loop unrolled)")


# ---------------------------------------------------------------------------
# collective sites
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective of the graph (a functional op folded with its
    wait, a ``batch_isend_irecv`` batch folded into one permute)."""
    name: str               # node name (the first node of a p2p batch)
    graph_op: str           # ATen/c10d op as recorded
    base_op: str            # one of COLLECTIVES, or an unmapped class
    form: str               # "inplace" | "functional" | "p2p"
    computation: str        # the graph's name
    mult: int               # executions (1: FX unrolls loops)
    operand_bytes: int      # payload: summed operand bytes
    result_bytes: int
    dtype: str              # dtype name of the first operand
    n_groups: int           # groups of this size in the world
    group_size: int         # participants of the group
    operands: tuple[str, ...]
    node: torch.fx.Node = dataclasses.field(compare=False, repr=False)
    #: the node whose value the consumers read (the wait of a functional
    #: op, the out buffer of an in-place gather); None for p2p
    value: object = dataclasses.field(default=None, compare=False,
                                      repr=False)
    #: the payload's nodes (``operands`` names them)
    inputs: tuple = dataclasses.field(default=(), compare=False, repr=False)


def _site(gm, node, base, form, payload, result, value, world):
    pg = _group_of(gm, node)
    size = pg.size() if pg is not None else world
    vals = [_val(n) for n in payload] or _tensors(_val(node))
    dt = dtype_name(vals[0].dtype) if vals else "float32"
    return CollectiveSite(
        name=node.name, graph_op=str(node.target), base_op=base, form=form,
        computation=type(gm).__name__, mult=1,
        operand_bytes=_node_bytes(payload), result_bytes=result,
        dtype=dt, n_groups=max(world // max(size, 1), 1),
        group_size=size, operands=tuple(n.name for n in payload),
        node=node, value=value, inputs=tuple(payload))


def collective_sites(gm: torch.fx.GraphModule) -> list[CollectiveSite]:
    """Every collective of the graph, in node order, functional ops
    paired with their waits and p2p batches folded.  Raises
    ``GraphParseError`` on an unwaited functional collective, a wait of no
    collective, or a higher-order op."""
    _check_flat(gm)
    world = module_world(gm)
    sites: list[CollectiveSite] = []
    batch: list = []                 # the open send/recv batch

    def close_batch():
        if not batch:
            return
        sends = [t for n in batch if _ns_name(n.target)[1] == "send"
                 for t in _tensor_nodes(n.args[0])]
        recvs = [t for n in batch if _ns_name(n.target)[1] == "recv_"
                 for t in _tensor_nodes(n.args[0])]
        payload = list(dict.fromkeys(sends)) or recvs[:1]
        sites.append(_site(gm, batch[0], "collective-permute", "p2p",
                           payload, _node_bytes(recvs[:1]), None, world))
        batch.clear()

    for n in gm.graph.nodes:
        if n.op == "get_attr":
            continue                  # a batch's process-group arguments
        ns, name = _ns_name(n.target) if n.op == "call_function" else ("",
                                                                       "")
        if ns == "c10d" and name in _P2P:
            if batch and _group_of(gm, batch[0]) is not _group_of(gm, n):
                close_batch()
            batch.append(n)
            continue
        close_batch()
        if ns == "c10d":
            base, k = _INPLACE.get(name, (name, 0))
            payload = _tensor_nodes(n.args[k]) if len(n.args) > k else []
            outs = _tensor_nodes(n.args[0]) if base in (
                "all-gather", "reduce-scatter", "all-to-all",
                "gather", "scatter") else payload
            value = next((u for u in n.users if u.target is operator.getitem
                          and u.args[1] == 0), None)
            sites.append(_site(gm, n, base, "inplace", payload,
                               _node_bytes(outs), value, world))
        elif ns in _FUNCTIONAL_NS and name == _WAIT:
            src = n.args[0]
            if not (isinstance(src, torch.fx.Node)
                    and _ns_name(src.target)[0] in _FUNCTIONAL_NS
                    and _ns_name(src.target)[1] != _WAIT):
                raise GraphParseError(
                    f"wait_tensor {n.name!r} waits on no collective "
                    f"({getattr(src, 'name', src)!r})")
        elif ns in _FUNCTIONAL_NS:
            waits = [u for u in n.users
                     if _ns_name(u.target) == (ns, _WAIT)
                     or _ns_name(u.target)[1] == _WAIT]
            if not waits:
                raise GraphParseError(
                    f"functional collective {n.name!r} ({name}) is never "
                    "waited on: its value would be read before it arrives")
            base = _FUNCTIONAL.get(name, name)
            payload = _tensor_nodes(n.args[0])
            sites.append(_site(gm, n, base, "functional", payload,
                               sum(_nbytes(t) for t in _tensors(_val(n))),
                               waits[0], world))
    close_batch()
    return sites


def collective_bytes(gm: torch.fx.GraphModule) -> dict:
    """Per-class operand bytes and call counts: ``{"all-gather": {"bytes":
    int, "count": int}, ..., "total_bytes": int}`` (the JAX package's
    ``collective_bytes`` of HLO text)."""
    out: dict[str, dict] = defaultdict(lambda: {"bytes": 0, "count": 0})
    for s in collective_sites(gm):
        out[s.base_op]["bytes"] += s.operand_bytes * s.mult
        out[s.base_op]["count"] += s.mult
    result = {k: dict(v) for k, v in out.items()}
    result["total_bytes"] = sum(v["bytes"] for v in out.values())
    return result


# ---------------------------------------------------------------------------
# program costs
# ---------------------------------------------------------------------------


#: ops that alias their input without declaring it in their schema
#: (``reshape`` lowers to ``clone`` + ``_unsafe_view`` of the copy)
_UNDECLARED_VIEWS = ("_unsafe_view",)


def is_view(target) -> bool:
    """An op whose outputs alias its input without writing it (``view``,
    ``permute``, ``expand``, ``select``, ``_unsafe_view``, ``getitem``
    ...)."""
    if target is operator.getitem or _ns_name(target)[1] in \
            _UNDECLARED_VIEWS:
        return True
    schema = getattr(target, "_schema", None)
    if schema is None or not schema.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def dot_flops(node: torch.fx.Node) -> int:
    """Flops of one node by ``torch.utils.flop_counter``'s formulas
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention;
    einsum lowers to these), 0 for any other op."""
    pkt = getattr(node.target, "overloadpacket", None)
    if pkt is None or pkt not in flop_registry:
        return 0
    args = pytree.tree_map(_val, node.args)
    kwargs = pytree.tree_map(_val, node.kwargs)
    return int(flop_registry[pkt](*args, **kwargs, out_val=_val(node)))


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of an operand: its logical size, but no more than
    its storage (a broadcast ``expand`` is read once)."""
    try:
        return min(_nbytes(t), t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return _nbytes(t)


def _key(t: torch.Tensor):
    return StorageWeakRef(t.untyped_storage())


def program_costs(gm: torch.fx.GraphModule) -> dict:
    """Costs of one captured program:

    * ``dot_flops``: the flop counter's formulas on every node's fake
      shapes (matmuls and attention; elementwise flops excluded);
    * ``bytes``: the input plus output bytes of every compute node, view
      ops excluded.  Eager PyTorch does not fuse, so this is what an
      eager run reads and writes (an upper bound on a fused program's
      device traffic);
    * the memory of the program (the counterpart of XLA's
      ``memory_analysis()``): ``argument_bytes`` and ``output_bytes``
      (storages of the placeholders and of the outputs, each counted
      once), and ``peak_live_bytes``, the most bytes of the other
      storages live at once when the nodes run in order and each storage
      is freed after the last use of any tensor on it.

    Raises ``GraphParseError`` on a higher-order op."""
    _check_flat(gm)
    nodes = list(gm.graph.nodes)
    order = {n: i for i, n in enumerate(nodes)}
    flops = 0
    byts = 0
    by_op: dict[str, int] = defaultdict(int)
    # storages: size, the node that made it, the last node that uses it
    size: dict = {}
    born: dict = {}
    last: dict = {}
    args_keys, out_keys = set(), set()
    for n in nodes:
        for t in _tensors(_val(n)):
            k = _key(t)
            size.setdefault(k, t.untyped_storage().nbytes())
            born.setdefault(k, order[n])
            last[k] = max(last.get(k, 0), order[n])
            if n.op == "placeholder":
                args_keys.add(k)
        for u in n.users:
            for t in _tensors(_val(n)):
                k = _key(t)
                last[k] = max(last[k], order[u])
        if n.op == "output":
            for a in _tensor_nodes(n.args):
                for t in _tensors(_val(a)):
                    out_keys.add(_key(t))
        if n.op != "call_function" or is_view(n.target):
            continue
        flops += dot_flops(n)
        ins = {id(_val(a)): _val(a) for a in _tensor_nodes((n.args,
                                                            n.kwargs))}
        b = sum(_read_bytes(t) for t in ins.values()) + sum(
            _nbytes(t) for t in _tensors(_val(n)))
        byts += b
        by_op[_ns_name(n.target)[1] or str(n.target)] += b
    allocs: dict[int, int] = defaultdict(int)
    frees: dict[int, int] = defaultdict(int)
    for k, i in born.items():
        if k in args_keys:
            continue
        allocs[i] += size[k]
        if k not in out_keys:
            frees[last[k]] += size[k]
    live = peak = 0
    for i in range(len(nodes)):
        live += allocs[i]
        peak = max(peak, live)
        live -= frees[i]
    return {"dot_flops": float(flops), "bytes": float(byts),
            "nodes": len(nodes),
            "argument_bytes": sum(size[k] for k in args_keys),
            "output_bytes": sum(size[k] for k in out_keys - args_keys),
            "peak_live_bytes": peak,
            "bytes_by_op": dict(sorted(by_op.items(),
                                       key=lambda kv: -kv[1])[:10])}


def tensor_bytes(v) -> int:
    """Bytes of every tensor in a (nested) value, each storage once."""
    seen = {}
    for t in _tensors(v):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


__all__ = ["COLLECTIVES", "CollectiveSite", "GraphParseError", "capture",
           "collective_bytes", "collective_sites", "dot_flops", "is_view",
           "module_world", "program_costs", "tensor_bytes"]
