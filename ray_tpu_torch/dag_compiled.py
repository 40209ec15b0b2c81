"""Compiled DAG execution (copy of ray_tpu/dag_compiled.py; reference:
python/ray/dag/compiled_dag_node.py:813 CompiledDAG +
experimental/channel/shared_memory_channel.py).

The reference pre-compiles an actor-task DAG into static shared-memory
channels plus a per-actor execution schedule, so a steady-state
``execute()`` does NO task submission: the driver writes the input
channel, each actor runs a persistent loop (read input channels →
execute method → write output channel), and the driver reads the output
channels. The TPU-first reading (SURVEY.md §2.3): the *device* side of
an aDAG is already compiled by XLA inside each jitted actor method; the
framework owns the host-side steady state, and that is exactly what the
channels carry. The same holds for the port on the card: each actor
method launches its own CUDA work, and the channels carry what the driver
and the actors hand each other on the host.

Compiling here means:
- the DAG is validated and topologically ordered ONCE,
- ClassNodes instantiate their actors ONCE; FunctionNodes get a
  dedicated executor actor so every compute node lives in a persistent
  process,
- one shm channel per cross-actor edge + per DAG output + ONE input
  channel; same-actor edges pass values in memory,
- each actor is sent ONE ``__ray_call__`` exec-loop task that serves
  every subsequent ``execute()`` — the task RPC path is not touched
  again.

``execute()`` returns a :class:`CompiledDAGRef`; ``ray_tpu_torch.get`` (or
``.get()``) blocks on the output channels. Executions pipeline: the
driver may run ahead of the actors by one value per channel (the
channels' ack backpressure bounds the pipeline depth, reference:
shared_memory_channel.py buffering).

If channel setup fails — e.g. an actor lives on another node where the
driver's shm segments don't resolve, or a local-mode actor, which runs no
``__ray_call__`` — compilation falls back to the task-submission path
(one RPC per node per execute), preserving behavior at lower throughput.
``_channel_mode`` says which path a compiled DAG took. Unlike the JAX
package, the setup handshake stops waiting as soon as an exec loop has
exited (its ``__ray_call__`` ref resolved) instead of running out its
120 s.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag import (
    ActorMethodNode,
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
)
from ray_tpu_torch.experimental.channel import Channel, ChannelTimeoutError

_STOP = "__ray_tpu_torch_dag_stop__"


class _DagErr:
    """A node failure traveling through channels to downstream nodes and
    the driver (reference: exceptions propagate through compiled-DAG
    channels as values)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class _LoopStop(Exception):
    """Raised inside an exec loop when the DAG is being torn down."""


def _mk_err(method_name: str, e: BaseException) -> "_DagErr":
    import traceback

    from ray_tpu_torch.exceptions import RayTaskError

    return _DagErr(pickle.dumps(RayTaskError(
        method_name,
        f"{type(e).__name__}: {e}\n{traceback.format_exc()}")))


def _read_block(reader, stopped):
    """Channel read in short ticks so a teardown signal (the stop
    channel's header advancing) frees even a loop whose upstream died."""
    while True:
        try:
            return reader.read(timeout=2.0)
        except ChannelTimeoutError:
            if stopped():
                raise _LoopStop from None


def _write_block(writer, value, stopped, method_name):
    """Channel write that (a) survives legitimate backpressure — an
    unread output slot is NOT a failure, tick until acked — and (b)
    converts an oversized value into a per-execute _DagErr instead of
    killing the loop."""
    while True:
        try:
            writer.write(value, timeout=2.0)
            return
        except ChannelTimeoutError:
            if stopped():
                raise _LoopStop from None
        except ValueError as e:  # payload exceeds channel capacity
            if isinstance(value, _DagErr):
                raise  # already minimal; give up
            value = _mk_err(method_name, e)


def _dag_exec_loop(instance, ready, input_reader, steps, chan_readers,
                   stop_reader):
    """Persistent per-actor execution loop, sent once via __ray_call__
    (reference: compiled_dag_node.py do_exec_tasks — the per-actor loop
    that replaces task submission in the steady state).

    ``steps``: ordered [(pos, method_name, arg_specs, kwarg_specs,
    writer)]; arg spec kinds: ("c", const) | ("i",) input | ("l", pos)
    same-actor value | ("r", dep_pos) cross-actor channel.
    ``chan_readers``: {dep_pos: ChannelReader} — ONE reader per upstream
    channel; each is read exactly once per iteration (a second read of
    the same value would block on the next sequence forever).
    ``stop_reader``: never read — its header seq advancing is the
    teardown signal every blocking tick polls, so the loop exits even
    when wedged on a dead upstream's edge channel.
    """

    def stopped() -> bool:
        return stop_reader._seq > 0

    ready.write("ready")
    try:
        while True:
            val = _read_block(input_reader, stopped)
            if isinstance(val, str) and val == _STOP:
                return "stopped"
            local: Dict[int, Any] = {}
            remote_vals: Dict[int, Any] = {}
            for pos, method_name, arg_specs, kwarg_specs, writer in steps:

                def _resolve(spec):
                    kind = spec[0]
                    if kind == "c":
                        return spec[1]
                    if kind == "i":
                        return val
                    if kind == "l":
                        return local[spec[1]]
                    dep = spec[1]  # "r"
                    if dep not in remote_vals:
                        remote_vals[dep] = _read_block(
                            chan_readers[dep], stopped)
                    return remote_vals[dep]

                args = [_resolve(s) for s in arg_specs]
                kwargs = {k: _resolve(s) for k, s in kwarg_specs.items()}
                err = next((a for a in args if isinstance(a, _DagErr)),
                           None) \
                    or next((v for v in kwargs.values()
                             if isinstance(v, _DagErr)), None)
                if err is not None:
                    result: Any = err  # skip execution, propagate fault
                else:
                    try:
                        if method_name == "__dag_fn__":
                            result = instance._fn(*args, **kwargs)
                        else:
                            result = getattr(instance, method_name)(
                                *args, **kwargs)
                    except BaseException as e:  # noqa: BLE001
                        result = _mk_err(method_name, e)
                local[pos] = result
                if writer is not None:
                    _write_block(writer, result, stopped, method_name)
    except _LoopStop:
        return "stopped"


class _FnExecutorHolder:
    """Instance living inside the dedicated actor a FunctionNode compiles
    into; the exec loop calls ``instance._fn``."""

    def __init__(self, fn_bytes: bytes):
        from ray_tpu_torch._private import cloudpickle

        self._fn = cloudpickle.loads(fn_bytes)


class _Slot:
    """Where one argument of a compiled node comes from."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any):
        self.kind = kind  # "const" | "node" | "input"
        self.value = value  # constant | node index | None


class CompiledDAGRef:
    """Result handle for one ``execute()`` (reference:
    compiled_dag_ref.py CompiledDAGRef): ``.get()`` — or ``ray_tpu_torch.get``
    — blocks on the DAG's output channels."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._consumed = False
        self._err: Optional[BaseException] = None

    def get(self, timeout: Optional[float] = None):
        # once-only, like the reference: the channel value is consumed
        # by the first get — a second would silently read a LATER
        # execution's output. An execution that raised is re-raised on
        # every get (the channel slot is already consumed; looping on it
        # would wait forever and steal later executions' outputs).
        if self._consumed:
            if self._err is not None:
                raise self._err
            raise ValueError(
                "CompiledDAGRef.get() can only be called once")
        # a timeout below leaves the ref unconsumed: _fetch_result only
        # pops the cache once every output channel has delivered
        vals = self._dag._fetch_result(self._idx, timeout)
        self._consumed = True
        out = []
        for v in vals:
            if isinstance(v, _DagErr):
                self._err = pickle.loads(v.data)
                raise self._err
            out.append(v)
        return out if self._dag._multi else out[0]


class CompiledDAG:
    """Host-side compiled schedule for a DAG (reference:
    compiled_dag_node.py:813)."""

    _READY_TIMEOUT_S = 120.0  # actor start can take seconds on small hosts
    _DEFAULT_BUFFER_BYTES = 4 << 20  # per-channel slot (reference:
    # compiled_dag_node.py _default_buffer_size_bytes)

    def __init__(self, root, buffer_size_bytes: Optional[int] = None,
                 **_kwargs):
        self._buffer_bytes = buffer_size_bytes or self._DEFAULT_BUFFER_BYTES
        self._outputs: List[DAGNode] = list(root) if isinstance(root, list) else [root]
        self._multi = isinstance(root, list)
        self._nodes: List[DAGNode] = []
        self._index: Dict[int, int] = {}  # id(node) -> schedule position
        self._slots: List[Tuple[List[_Slot], Dict[str, _Slot]]] = []
        self._handles: Dict[int, Any] = {}  # schedule pos of ClassNode -> actor
        self._fn_actors: Dict[int, Any] = {}  # pos of FunctionNode -> actor
        self._torn_down = False
        for out in self._outputs:
            self._visit(out)
        self._compile()
        # channel steady state (may be unavailable -> task-path fallback)
        self._channel_mode = False
        self._write_lock = threading.Lock()
        self._read_lock = threading.Lock()
        self._exec_count = 0
        self._read_cursor = 0
        self._result_cache: Dict[int, Any] = {}
        self._partial: List[Any] = []  # outputs read so far this cursor
        try:
            self._compile_channels()
            self._channel_mode = True
        except Exception as e:  # noqa: BLE001 — fall back to task path
            import logging

            import ray_tpu_torch as rt

            logging.getLogger(__name__).info(
                "compiled DAG falls back to task path: %s", e)
            # exec loops may already be running inside the DAG's actors
            # (e.g. one actor attached its channels, another could not):
            # a _STOP through the input channel releases them — otherwise
            # they'd occupy the actor's execution thread forever and the
            # task-path fallback would hang behind them
            sc = getattr(self, "_stop_channel", None)
            if sc is not None:
                try:
                    sc.write(b"stop", timeout=1.0)
                except Exception:  # noqa: BLE001
                    pass
            ic = getattr(self, "_input_channel", None)
            if ic is not None:
                try:
                    ic.write(_STOP, timeout=2.0)
                except Exception:  # noqa: BLE001
                    pass
            self._close_channels()
            for h in self._fn_actors.values():
                try:
                    rt.kill(h)
                except Exception:  # noqa: BLE001
                    pass
            self._fn_actors.clear()

    # -- compile --------------------------------------------------------
    def _visit(self, node: DAGNode) -> int:
        if id(node) in self._index:
            return self._index[id(node)]
        if isinstance(node, ClassMethodNode):
            self._visit(node._class_node)
        for v in list(node._bound_args) + list(node._bound_kwargs.values()):
            if isinstance(v, DAGNode):
                self._visit(v)
        pos = len(self._nodes)
        self._index[id(node)] = pos
        self._nodes.append(node)
        return pos

    def _slot(self, v) -> _Slot:
        if isinstance(v, InputNode):
            return _Slot("input", None)
        if isinstance(v, DAGNode):
            return _Slot("node", self._index[id(v)])
        return _Slot("const", v)

    def _compile(self) -> None:
        n_inputs = sum(1 for n in self._nodes if isinstance(n, InputNode))
        if n_inputs > 1:
            raise ValueError("compiled DAGs support at most one InputNode")
        for node in self._nodes:
            args = [self._slot(a) for a in node._bound_args]
            kwargs = {k: self._slot(v) for k, v in node._bound_kwargs.items()}
            self._slots.append((args, kwargs))
            if isinstance(node, ClassNode):
                # actors are part of the compiled graph: created once here
                pos = self._index[id(node)]
                cargs = [s.value for s in args]
                if any(s.kind != "const" for s in args) or any(
                    s.kind != "const" for s in kwargs.values()
                ):
                    raise ValueError(
                        "compiled ClassNode constructor args must be constants"
                    )
                self._handles[pos] = node._actor_cls._remote(
                    tuple(cargs), {k: s.value for k, s in kwargs.items()},
                    node._options,
                )

    # -- channel steady state ------------------------------------------
    def _owner_key(self, pos: int):
        """Which persistent process executes node `pos` (actor id hex)."""
        node = self._nodes[pos]
        if isinstance(node, ClassMethodNode):
            h = self._handles[self._index[id(node._class_node)]]
        elif isinstance(node, ActorMethodNode):
            h = node._handle
        elif isinstance(node, FunctionNode):
            h = self._fn_actors[pos]
        else:
            return None
        return h._actor_id.hex()

    def _compile_channels(self) -> None:
        import ray_tpu_torch as rt

        compute = [pos for pos, n in enumerate(self._nodes)
                   if not isinstance(n, (InputNode, ClassNode))]
        if not compute:
            raise ValueError("no compute nodes to compile")

        # dedicated executor actor per FunctionNode: every compute node
        # must live in a persistent process for the loop to run in
        from ray_tpu_torch._private import cloudpickle

        for pos in compute:
            node = self._nodes[pos]
            if isinstance(node, FunctionNode):
                opts = {k: v for k, v in (node._options or {}).items()
                        if k in ("num_cpus", "num_gpus", "resources",
                                 "scheduling_strategy")}
                self._fn_actors[pos] = rt.remote(
                    _FnExecutorHolder).options(**opts).remote(
                    cloudpickle.dumps(node._remote_fn._function))

        handle_of: Dict[str, Any] = {}
        owner: Dict[int, str] = {}
        for pos in compute:
            key = self._owner_key(pos)
            owner[pos] = key
            node = self._nodes[pos]
            if isinstance(node, ClassMethodNode):
                handle_of[key] = self._handles[
                    self._index[id(node._class_node)]]
            elif isinstance(node, ActorMethodNode):
                handle_of[key] = node._handle
            else:
                handle_of[key] = self._fn_actors[pos]
        schedule_keys = list(dict.fromkeys(owner[p] for p in compute))

        # channels: one per node consumed across actors or by the driver
        out_positions = [self._index[id(o)] for o in self._outputs]
        consumers: Dict[int, List[str]] = {}
        for pos in compute:
            for s in self._slots[pos][0] + list(self._slots[pos][1].values()):
                if s.kind == "node":
                    dep = s.value
                    if owner.get(dep) is not None and owner[dep] != owner[pos]:
                        lst = consumers.setdefault(dep, [])
                        if owner[pos] not in lst:
                            lst.append(owner[pos])
        self._edge_channels: Dict[int, Channel] = {}
        reader_idx: Dict[Tuple[int, str], int] = {}
        self._out_readers: List[Any] = []
        for dep in set(list(consumers) + out_positions):
            keys = consumers.get(dep, [])
            n_readers = len(keys) + (1 if dep in out_positions else 0)
            ch = Channel(capacity=self._buffer_bytes, num_readers=n_readers)
            self._edge_channels[dep] = ch
            for i, k in enumerate(keys):
                reader_idx[(dep, k)] = i
        for dep in out_positions:
            ch = self._edge_channels[dep]
            self._out_readers.append(
                ch.reader(ch.num_readers - 1))

        # ONE input channel read by every schedule: it is the iteration
        # trigger even for schedules whose nodes take no input
        self._input_channel = Channel(capacity=self._buffer_bytes,
                                      num_readers=len(schedule_keys))
        # never read by anyone: a teardown write advances its header seq,
        # which every exec-loop blocking tick polls as the stop signal
        self._stop_channel = Channel(capacity=64,
                                     num_readers=len(schedule_keys))

        # build + ship per-actor schedules
        self._ready_readers = []
        self._ready_channels = []  # keep writer endpoints alive: their
        # GC would unlink the shm segment before the actor attaches
        self._loop_refs = []
        for si, key in enumerate(schedule_keys):
            steps = []
            chan_readers: Dict[int, Any] = {}
            for pos in compute:
                if owner[pos] != key:
                    continue
                node = self._nodes[pos]
                if isinstance(node, (ClassMethodNode, ActorMethodNode)):
                    method = node._method_name
                else:
                    method = "__dag_fn__"

                def spec_of(s: _Slot):
                    if s.kind == "const":
                        return ("c", s.value)
                    if s.kind == "input":
                        return ("i",)
                    dep = s.value
                    if isinstance(self._nodes[dep], InputNode):
                        return ("i",)
                    if isinstance(self._nodes[dep], ClassNode):
                        raise ValueError(
                            "actor handles cannot flow through channels")
                    if owner[dep] == key:
                        return ("l", dep)
                    if dep not in chan_readers:
                        ch = self._edge_channels[dep]
                        chan_readers[dep] = ch.reader(
                            reader_idx[(dep, key)])
                    return ("r", dep)

                arg_specs = [spec_of(s) for s in self._slots[pos][0]]
                kwarg_specs = {k: spec_of(s)
                               for k, s in self._slots[pos][1].items()}
                steps.append((pos, method, arg_specs, kwarg_specs,
                              self._edge_channels.get(pos)))
            ready = Channel(num_readers=1)
            self._ready_channels.append(ready)
            self._ready_readers.append(ready.reader(0))
            self._loop_refs.append(
                handle_of[key].__ray_call__.remote(
                    _dag_exec_loop, ready, self._input_channel.reader(si),
                    steps, chan_readers, self._stop_channel.reader(si)))
        # handshake: every exec loop attached its channels and is serving;
        # read in ticks, so a loop that exited (e.g. on an actor that runs
        # no __ray_call__) ends the wait at once
        deadline = time.monotonic() + self._READY_TIMEOUT_S
        for rd in self._ready_readers:
            while True:
                try:
                    got = rd.read(timeout=0.5)
                    break
                except ChannelTimeoutError:
                    done, _ = rt.wait(self._loop_refs, num_returns=1, timeout=0)
                    if done or time.monotonic() > deadline:
                        raise RuntimeError(
                            "an exec loop exited before its handshake"
                            if done else "exec loop handshake timed out") from None
            if got != "ready":
                raise RuntimeError("exec loop handshake failed")

    def _close_channels(self) -> None:
        for ch in list(getattr(self, "_edge_channels", {}).values()):
            ch.close()
        for ch in list(getattr(self, "_ready_channels", [])):
            ch.close()
        ic = getattr(self, "_input_channel", None)
        if ic is not None:
            ic.close()
        sc = getattr(self, "_stop_channel", None)
        if sc is not None:
            sc.close()
        self._edge_channels = {}
        self._ready_channels = []
        self._input_channel = None
        self._stop_channel = None

    # -- execute --------------------------------------------------------
    def execute(self, *input_values):
        if self._torn_down:
            raise RuntimeError("CompiledDAG was torn down")
        input_value = input_values[0] if input_values else None
        if self._channel_mode:
            with self._write_lock:
                # the write backpressures on channel acks: the driver can
                # pipeline at most one value ahead per channel slot. Tick
                # so a dead exec loop (stopped acking) surfaces as an
                # error instead of wedging the writer — and teardown
                # (which sets _torn_down) can reclaim the lock. The index
                # is claimed only AFTER the write succeeds: a failed
                # write (e.g. oversized input) must not desynchronize
                # CompiledDAGRef indices from the read cursor.
                import ray_tpu_torch as rt

                while True:
                    if self._torn_down:
                        raise RuntimeError("CompiledDAG was torn down")
                    try:
                        self._input_channel.write(input_value, timeout=2.0)
                        break
                    except ChannelTimeoutError:
                        done, _ = rt.wait(self._loop_refs,
                                               num_returns=1, timeout=0)
                        if done:
                            rt.get(done[0])
                            raise RuntimeError(
                                "a compiled-DAG exec loop exited"
                            ) from None
                idx = self._exec_count
                self._exec_count += 1
            return CompiledDAGRef(self, idx)
        return self._execute_taskpath(input_value)

    def _read_output(self, rd, timeout: Optional[float]):
        """One output-channel read in short ticks, detecting a dead exec
        loop (its __ray_call__ ref resolves early) instead of hanging."""
        import ray_tpu_torch as rt

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return rd.read(timeout=2.0)
            except ChannelTimeoutError:
                if self._torn_down:
                    raise RuntimeError("CompiledDAG was torn down") from None
                done, _ = rt.wait(self._loop_refs,
                                       num_returns=1, timeout=0)
                if done:
                    # surfaces the loop's error (e.g. its actor died)
                    rt.get(done[0])
                    raise RuntimeError(
                        "a compiled-DAG exec loop exited") from None
                if deadline is not None and time.monotonic() > deadline:
                    from ray_tpu_torch.exceptions import GetTimeoutError

                    raise GetTimeoutError(
                        f"compiled DAG output not ready within "
                        f"{timeout}s") from None

    def _fetch_result(self, idx: int, timeout: Optional[float]):
        """Pop execution ``idx``'s raw output list (``_DagErr`` entries
        included — CompiledDAGRef.get unwraps them so it can record the
        consumption before raising)."""
        with self._read_lock:
            while idx not in self._result_cache:
                if self._torn_down:
                    raise RuntimeError("CompiledDAG was torn down")
                # one output at a time, stashing partial progress: a
                # timeout after output A was consumed but before slow
                # output B must NOT discard A — the retry would pair
                # A's next execution with B's current one, shifting
                # every later result
                while len(self._partial) < len(self._out_readers):
                    rd = self._out_readers[len(self._partial)]
                    self._partial.append(self._read_output(rd, timeout))
                vals, self._partial = self._partial, []
                self._result_cache[self._read_cursor] = vals
                self._read_cursor += 1
            return self._result_cache.pop(idx)

    def _execute_taskpath(self, input_value):
        """Fallback: per-execute task submission (pre-channel behavior)."""
        results: List[Any] = [None] * len(self._nodes)

        def resolve(slot: _Slot):
            if slot.kind == "const":
                return slot.value
            if slot.kind == "input":
                return input_value
            return results[slot.value]

        for pos, node in enumerate(self._nodes):
            arg_slots, kwarg_slots = self._slots[pos]
            if isinstance(node, InputNode):
                results[pos] = input_value
                continue
            if isinstance(node, ClassNode):
                results[pos] = self._handles[pos]
                continue
            args = tuple(resolve(s) for s in arg_slots)
            kwargs = {k: resolve(s) for k, s in kwarg_slots.items()}
            if isinstance(node, FunctionNode):
                results[pos] = node._remote_fn._remote(args, kwargs, node._options)
            elif isinstance(node, ClassMethodNode):
                handle = self._handles[self._index[id(node._class_node)]]
                results[pos] = handle._actor_method_call(node._method_name, args, kwargs)
            elif isinstance(node, ActorMethodNode):
                results[pos] = node._handle._actor_method_call(
                    node._method_name, args, kwargs
                )
            else:
                raise TypeError(f"cannot compile node type {type(node).__name__}")
        outs = [results[self._index[id(o)]] for o in self._outputs]
        return outs if self._multi else outs[0]

    def teardown(self) -> None:
        """Stop exec loops and kill actors this compiled DAG created
        (reference: CompiledDAG.teardown). Ordering matters for actors
        the DAG did NOT create (ActorMethodNode handles, which stay
        alive for their owner): their loops must see _STOP, which needs
        (a) output channels drained so blocked writers progress, and
        (b) the input channel free of a wedged concurrent execute() —
        _torn_down makes that writer bail within one tick."""
        import ray_tpu_torch as rt

        if self._torn_down:
            return
        self._torn_down = True
        if self._channel_mode:
            # stop signal FIRST: every exec-loop blocking tick polls this
            # channel's header, so even a loop wedged on a dead
            # upstream's edge exits within one tick
            try:
                self._stop_channel.write(b"stop", timeout=1.0)
            except Exception:  # noqa: BLE001
                pass
            # let a blocked execute()/get() observe _torn_down and exit
            got_write = self._write_lock.acquire(timeout=10.0)
            got_read = self._read_lock.acquire(timeout=10.0)
            try:
                # drain unread outputs so exec loops blocked writing a
                # full output slot can reach their input read
                for rd in self._out_readers:
                    while True:
                        try:
                            rd.read(timeout=0.2)
                        except ChannelTimeoutError:
                            break
                try:
                    # unblocks every schedule's input read; loops exit
                    self._input_channel.write(_STOP, timeout=5.0)
                except Exception:  # noqa: BLE001
                    pass
            finally:
                if got_read:
                    self._read_lock.release()
                if got_write:
                    self._write_lock.release()
        for handle in list(self._handles.values()) + list(
                self._fn_actors.values()):
            try:
                rt.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        self._handles.clear()
        self._fn_actors.clear()
        self._close_channels()

    def __del__(self):
        try:
            if not self._torn_down and (self._fn_actors or self._channel_mode):
                self.teardown()
        except Exception:  # noqa: BLE001
            pass
