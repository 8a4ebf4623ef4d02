"""Compiled-task runtime: mega_ag.json → one jitted XLA program.

This framework's replacement for the reference's C++ dataflow scheduler
(mega_ag_runners/mega_ag.cpp:125 MegaAG::load +
mega_ag_runners/cpu_task_utils.h:378 run_tasks). Where the reference
interprets the graph with a 32-thread priority pool — one mutex-guarded
dispatch per multi-ms FHE op — this loader topologically sorts the graph
once at load time and *traces the whole task into a single XLA program*:

- per-op executor dispatch (input-shape–selected variants, matching
  mega_ag_runners/cpu/mega_ag_executors_cpu.cpp:96-505) happens at load
  time, not run time;
- XLA's scheduler replaces the priority queue (bottom-level priorities are
  moot: the compiler sees the whole dependency graph);
- ref-count memory purging (cpu_task_utils.h:282) becomes XLA buffer
  liveness + donated input buffers;
- the ABI bridge (EXPORT/IMPORT_TO_ABI node insertion, mega_ag.cpp:307-585)
  becomes the host↔device boundary of `jax.jit` itself.

An eager NumPy interpreter mode (`mode='eager'`) mirrors the reference CPU
runner op-for-op for debugging and as the conformance oracle.
"""

import json
import logging
import os
import time

import numpy as np

from ..params import params_from_task_json
from ..schemes.bfv import BfvEngine
from ..schemes.ckks import CkksEngine
from ..schemes.types import (Ciphertext, KeySwitchKey, Plaintext, PlaintextMul,
                             PlaintextRingt)
from . import check_sig

_KEY_TYPES = ('rlk', 'glk', 'swk')
_log = logging.getLogger(__name__)
_HOST_POOL = None          # shared partitioned-mode host-executor pool


class _Node:
    __slots__ = ('index', 'id', 'type', 'level', 'degree', 'is_ntt', 'is_mform',
                 'sp_level', 'galois_element', 'is_custom', 'attributes',
                 'sp_decomped', 'is_compressed')

    def __init__(self, index: int, d: dict):
        self.index = index
        self.id = d['id']
        self.type = d['type']
        self.level = d.get('level', -1)
        self.degree = d.get('degree', -1)
        self.is_ntt = d.get('is_ntt', False)
        self.is_mform = d.get('is_mform', False)
        self.sp_level = d.get('sp_level')
        self.galois_element = d.get('galois_element')
        self.is_custom = d.get('is_custom', False)
        self.attributes = d.get('attributes', {})
        self.sp_decomped = d.get('poly1_rns_sp_decomped', False)
        self.is_compressed = d.get('is_compressed', False)


def _wrap_input(node: _Node, array, scale: float):
    """Array → typed carrier using the data node's static metadata."""
    if node.is_custom:
        return array            # custom payloads pass through untyped
    t = node.type
    if t in ('ct', 'ct3'):
        return Ciphertext(data=array, level=node.level, is_ntt=node.is_ntt,
                          is_mform=node.is_mform, scale=scale)
    if t == 'pt':
        return Plaintext(data=array, level=node.level, is_ntt=node.is_ntt,
                         scale=scale)
    if t == 'pt_ringt':
        return PlaintextRingt(data=array, scale=scale)
    if t == 'pt_mul':
        return PlaintextMul(data=array, level=node.level, scale=scale)
    raise ValueError(f'cannot wrap input of type {t}')


class FheTaskTpu:
    """Loads a compiled task directory and runs it on device (jit) or host.

    API parity with the reference SDK entry point FheTaskCpu
    (cxx_sdk_v2/cxx_fhe_task.h:117): construct from the task directory,
    then ``run(context, inputs)`` → (outputs, duration_ns).
    """

    def __init__(self, task_dir: str, mode: str = 'jit', donate_inputs: bool = False,
                 custom_executors: dict | None = None, batch_fuse: bool = True,
                 mesh=None):
        with open(os.path.join(task_dir, 'mega_ag.json')) as f:
            self.mag = json.load(f)
        with open(os.path.join(task_dir, 'task_signature.json')) as f:
            self.signature = json.load(f)
        assert mode in ('jit', 'eager', 'partitioned')
        self.mode = mode
        self.donate_inputs = donate_inputs
        # user executors for custom compute nodes, keyed by node type
        # (reference: bind_*_task_custom_executors, wrapper.h:31-105)
        self.custom_executors = custom_executors or {}
        self.batch_fuse = batch_fuse
        # Graph-level placement: iso-op groups sharded over the mesh's
        # ``op`` axis — the equivalent of the reference scheduler
        # dispatching independent DAG ops across its thread pool / backend
        # (cpu_task_utils.h:540-546). XLA GSPMD places each group member
        # on a mesh device and runs groups concurrently.
        self.mesh = mesh
        # seconds the last partitioned run spent compiling bootstrap
        # segments (None until one compiled)
        self.last_compile_s = None
        self._offline: dict = {}
        self.params = params_from_task_json(self.mag['parameter'])
        self.algo = self.mag['algorithm']
        self.engine = (BfvEngine if self.algo == 'BFV' else CkksEngine)(self.params)
        self.data = {int(k): _Node(int(k), v) for k, v in self.mag['data'].items()}
        self.inputs = list(self.mag['inputs'])
        self.outputs = list(self.mag['outputs'])
        self._build_plan()
        self._jitted = None
        self._out_scales: dict = {}

    @staticmethod
    def _host_pool():
        """Shared process-wide thread pool for host (custom) executors in
        partitioned mode — the reference's CPU bridge pool (min(16,hw)-2
        workers, gpu_wrapper.cu:157-172) that lets host work overlap
        backend execution. Module-level so many task objects don't each
        pin worker threads."""
        global _HOST_POOL
        if _HOST_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _HOST_POOL = ThreadPoolExecutor(
                max_workers=max(2, min(16, os.cpu_count() or 1) - 2),
                thread_name_prefix='lattisense-host')
        return _HOST_POOL

    # ------------------------------------------------------------------
    # Plan construction (load-time executor binding, reference parity:
    # MegaAG::from_json + bind_cpu_executor)
    # ------------------------------------------------------------------
    def _build_plan(self):
        computes = {int(k): v for k, v in self.mag['compute'].items()}
        # topo order over compute nodes (Kahn on data availability); the
        # ready waves double as layers for the iso-op batching pass
        available = set(self.inputs)
        pending = dict(computes)
        order, layers = [], []
        while pending:
            ready = [idx for idx, c in pending.items()
                     if all(i in available for i in c['inputs'])]
            if not ready:
                raise ValueError('mega_ag graph contains a cycle or missing input')
            wave = []
            for idx in sorted(ready):
                c = pending.pop(idx)
                order.append(c)
                wave.append(c)
                for o in computes[idx]['outputs']:
                    available.add(o)
            layers.append(wave)
        self.plan_meta = []
        if self.batch_fuse and self.mode in ('jit', 'partitioned'):
            self.plan = self._build_batched_plan(layers)
        else:
            self.plan = [self._bind_executor(c) for c in order]
            self.plan_meta = [self._step_meta([c]) for c in order]

    # ------------------------------------------------------------------
    # Iso-op batching: reference graphs carry many structurally identical
    # parallel ops (e.g. benchmark_cpu's 1024 mult_relins; the reference
    # extracts parallelism with a thread pool, cpu_task_utils.h:378). Here
    # identical ops within a topo wave fuse into ONE vmapped executor:
    # traces shrink by the group size and the device runs batched kernels.
    # ------------------------------------------------------------------
    def _node_sig(self, i: int):
        nd = self.data[i]
        return (nd.type, nd.level, nd.degree, nd.is_ntt, nd.is_mform,
                nd.sp_level, nd.galois_element, nd.is_compressed,
                nd.sp_decomped)

    def _compute_sig(self, c: dict):
        static = {k: v for k, v in c.items()
                  if k not in ('id', 'inputs', 'outputs')}
        return (json.dumps(static, sort_keys=True),
                tuple(self._node_sig(i) for i in c['inputs']))

    def _build_batched_plan(self, layers):
        plan = []
        for wave in layers:
            groups: dict = {}
            for c in wave:
                groups.setdefault(self._compute_sig(c), []).append(c)
            for members in groups.values():
                if len(members) == 1 or members[0].get('is_custom') \
                        or members[0]['type'] == 'bootstrap':
                    plan += [self._bind_executor(c) for c in members]
                    self.plan_meta += [self._step_meta([c]) for c in members]
                else:
                    plan.append(self._bind_group_executor(members))
                    self.plan_meta.append(self._step_meta(members))
        return plan

    @staticmethod
    def _step_meta(members):
        ins, outs = set(), set()
        for c in members:
            ins.update(c['inputs'])
            outs.update(c['outputs'])
        return {'inputs': ins, 'outputs': outs,
                'custom': bool(members[0].get('is_custom')),
                'op': members[0]['type']}

    def _bind_group_executor(self, members):
        import jax

        template = members[0]
        run_one = self._bind_executor(template)
        in_tmpl = list(template['inputs'])
        data_pos = [k for k, i in enumerate(in_tmpl)
                    if self.data[i].type not in _KEY_TYPES]
        out_tmpl = template['outputs'][0]
        member_ins = [[c['inputs'][k] for k in data_pos] for c in members]
        member_outs = [c['outputs'][0] for c in members]

        def single(vals, keys, xp):
            env = {}
            for k, v in zip(data_pos, vals):
                env[in_tmpl[k]] = v
            run_one(env, xp, keys)
            return env[out_tmpl]

        mesh = self.mesh

        def _place(stacked, xp):
            """Constrain each stacked group axis onto the op mesh axis; when
            the mesh also carries a ``limb`` and/or ``coeff`` axis, shard
            each member's RNS limb axis (second-to-last) and/or coefficient
            axis (last) across them — kernel-level limb TP / coefficient
            sharding composed with graph-level placement, GSPMD inserting
            the collectives where the axes interact (base conversion
            and key-switch inner products for limbs; NTT butterflies and
            Galois permutations for coefficients)."""
            if mesh is None or xp.__name__ == 'numpy':
                return stacked
            from jax.sharding import NamedSharding, PartitionSpec
            limb = 'limb' if 'limb' in mesh.axis_names else None
            coeff = 'coeff' if 'coeff' in mesh.axis_names else None
            op = 'op' if 'op' in mesh.axis_names else None

            def constrain(x):
                spec = ((op,) + (None,) * (x.ndim - 3) + (limb, coeff)
                        if (limb or coeff) and x.ndim >= 3 else (op,))
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(mesh, PartitionSpec(*spec)))

            return [jax.tree.map(constrain, s) for s in stacked]

        def run(env, xp, keys):
            try:
                stacked = _place([jax.tree.map(lambda *xs: xp.stack(xs),
                                               *[env[i] for i in ins])
                                  for ins in zip(*member_ins)], xp)
                out = jax.vmap(lambda v, k: single(v, k, xp),
                               in_axes=(0, None))(stacked, keys)
            except Exception as exc:
                # heterogeneous aux metadata (e.g. CKKS scales): run unbatched.
                # Loud on purpose — losing iso-op batching silently would drop
                # the runtime's main parallelism mechanism.
                _log.warning(
                    'iso-op batching fell back to per-op execution for %d %r '
                    'ops (%s: %s); throughput will degrade',
                    len(members), members[0].get('type'),
                    type(exc).__name__, exc)
                for c in members:
                    self._bind_executor(c)(env, xp, keys)
                return
            for k, o in enumerate(member_outs):
                env[o] = jax.tree.map(lambda x: x[k], out)
        return run

    def _classify_inputs(self, c: dict):
        """Split compute inputs into (cts, ct3s, pts, key_nodes) preserving
        order — the executor-selection rule of CPU_EXECUTOR_SETUP
        (mega_ag_executors_cpu.cpp:33)."""
        cts, ct3s, pts, keys = [], [], [], []
        for i in c['inputs']:
            node = self.data[i]
            if node.type == 'ct':
                cts.append(node)
            elif node.type == 'ct3':
                ct3s.append(node)
            elif node.type in ('pt', 'pt_ringt', 'pt_mul'):
                pts.append(node)
            elif node.type in ('rlk', 'glk', 'swk'):
                keys.append(node)
            else:
                raise ValueError(f'unknown input datum type {node.type}')
        return cts, ct3s, pts, keys

    def _bind_executor(self, c: dict):
        """One compute node → closure(env, xp, keys). Dispatch mirrors
        bind_cpu_{add,sub,...} (mega_ag_executors_cpu.cpp:96-505)."""
        op = c['type']
        eng = self.engine
        out_idx = c['outputs'][0] if c['outputs'] else None

        if c.get('is_custom'):
            fn = self.custom_executors.get(op)
            if fn is None:
                raise ValueError(f'no executor bound for custom compute type '
                                 f'"{op}"; pass custom_executors={{...}}')
            in_nodes = [self.data[i] for i in c['inputs']]
            attrs = c.get('attributes', {})

            def run(env, xp, keys):
                env[out_idx] = fn(xp, eng, [env[n.index] for n in in_nodes],
                                  attrs)
            return run

        cts, ct3s, pts, keynodes = self._classify_inputs(c)

        def ctv(env, k=0):
            return env[cts[k].index]

        if op in ('add', 'sub'):
            f = eng.add if op == 'add' else eng.sub
            if len(c['inputs']) == 1:
                def run(env, xp, keys):
                    env[out_idx] = f(xp, ctv(env), ctv(env))
            elif pts:
                pi = pts[0].index

                def run(env, xp, keys):
                    env[out_idx] = f(xp, ctv(env), env[pi])
            else:
                def run(env, xp, keys):
                    env[out_idx] = f(xp, ctv(env), env[cts[1].index])
            return run

        if op == 'neg':
            def run(env, xp, keys):
                env[out_idx] = eng.neg(xp, ctv(env))
            return run

        if op == 'mult':
            if len(c['inputs']) == 1:
                def run(env, xp, keys):
                    env[out_idx] = eng.mult(xp, ctv(env), ctv(env))
            elif pts and pts[0].is_compressed:
                # compressed pt_ringt storage: the op consumes one block,
                # selected by the node's compressed_block_info
                pi = pts[0].index
                block = int(c['compressed_block_info'][0])

                def run(env, xp, keys):
                    pt = PlaintextRingt(data=env[pi].data[block])
                    env[out_idx] = eng.mult(xp, ctv(env), pt)
            elif pts:
                pi = pts[0].index

                def run(env, xp, keys):
                    env[out_idx] = eng.mult(xp, ctv(env), env[pi])
            else:
                def run(env, xp, keys):
                    env[out_idx] = eng.mult(xp, ctv(env), env[cts[1].index])
            return run

        if op == 'relin':
            src = ct3s[0].index

            def run(env, xp, keys):
                env[out_idx] = eng.relinearize(xp, env[src], keys['rlk'])
            return run

        if op == 'rescale':
            def run(env, xp, keys):
                env[out_idx] = eng.rescale(xp, ctv(env))
            return run

        if op == 'drop_level':
            if self.algo == 'BFV':
                raise ValueError('DROP_LEVEL only supported for CKKS scheme')

            def run(env, xp, keys):
                env[out_idx] = eng.drop_level(xp, ctv(env), 1)
            return run

        if op in ('rotate_col', 'rotate_row'):
            elt = keynodes[0].galois_element
            if cts[0].sp_decomped:
                out_node = self.data[out_idx]
                out_ntt, out_mform = out_node.is_ntt, out_node.is_mform

                def run(env, xp, keys):
                    env[out_idx] = eng.apply_galois_decomposed(
                        xp, env[cts[0].index], elt, keys['glk'][elt],
                        out_ntt=out_ntt, out_mform=out_mform)
                return run

            if self.algo == 'BFV':
                out_node = self.data[out_idx]
                o_ntt, o_mf = out_node.is_ntt, out_node.is_mform

                def run(env, xp, keys):
                    env[out_idx] = eng.apply_galois(xp, ctv(env), elt,
                                                    keys['glk'][elt],
                                                    out_ntt=o_ntt, out_mform=o_mf)
                return run

            def run(env, xp, keys):
                env[out_idx] = eng.apply_galois(xp, ctv(env), elt, keys['glk'][elt])
            return run

        if op in ('cmp_sum', 'cmpac_sum'):
            n = c['sum_cnt']
            accumulate = op == 'cmpac_sum'
            ct_nodes = cts[:n]
            acc_node = cts[n] if accumulate else None
            if pts and pts[0].is_compressed:
                pi = pts[0].index
                blocks = [int(b) for b in c['compressed_block_info']]

                def get_pt(env, i):
                    return PlaintextRingt(data=env[pi].data[blocks[i]])
            else:
                pt_nodes = pts[:n]

                def get_pt(env, i):
                    return env[pt_nodes[i].index]

            def run(env, xp, keys):
                total = None
                for i, ci in enumerate(ct_nodes):
                    prod = eng.mult(xp, env[ci.index], get_pt(env, i))
                    total = prod if total is None else eng.add(xp, total, prod)
                if acc_node is not None:
                    total = eng.add(xp, total, env[acc_node.index])
                env[out_idx] = total
            return run

        if op == 'bootstrap':
            def run(env, xp, keys):
                ct = env[cts[0].index]
                input_scale = ct.scale
                ct = Ciphertext(data=ct.data, level=ct.level, is_ntt=ct.is_ntt,
                                scale=self.params.scale)
                out = eng.bootstrap(xp, ct, keys)
                out.scale = input_scale
                env[out_idx] = out
            return run

        if op in ('to_ntt', 'to_inv_ntt', 'to_mf', 'to_mul'):
            meth = getattr(eng, op)

            def run(env, xp, keys):
                env[out_idx] = meth(xp, ctv(env))
            return run

        if op == 'rns_sp_decomp':
            def run(env, xp, keys):
                env[out_idx] = eng.rns_sp_decomp(xp, ctv(env))
            return run

        raise ValueError(f'unknown operation type "{op}"')

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def _key_signature_order(self):
        """The serializer appends key nodes to mega_ag.inputs after the data
        args: rlk, then glk (col then row, dict order), then btp swks
        (frontend/custom_task.py process_custom_task)."""
        return [i for i in self.inputs if self.data[i].type in _KEY_TYPES]

    def _data_input_nodes(self):
        return [self.data[i] for i in self.inputs
                if self.data[i].type not in _KEY_TYPES]

    def _flatten_args(self, input_values: dict):
        """Positional binding: signature row order × row-major flattening,
        exactly like CArgument marshaling (cpu_task_utils.h:235)."""
        flat = []
        rows = [r for r in self.signature['online'] if r['phase'] == 'in']
        rows += self.signature.get('offline', [])
        for row in rows:
            flat += check_sig.flatten(input_values[row['id']])
        return flat

    def _build_keys(self, key_tree):
        """key pytree → typed KeySwitchKey env (shared by all run modes)."""
        keys = {'rlk': None, 'glk': {}, 'swk': {}}
        for i in self._key_signature_order():
            node = self.data[i]
            if node.type == 'rlk':
                kq, kp = key_tree['rlk']
                keys['rlk'] = KeySwitchKey(key_q=kq, key_p=kp, level=node.level,
                                           sp_level=node.sp_level)
            elif node.type == 'glk':
                kq, kp = key_tree['glk'][node.galois_element]
                keys['glk'][node.galois_element] = KeySwitchKey(
                    key_q=kq, key_p=kp, level=node.level, sp_level=node.sp_level)
            elif node.type == 'swk':
                kq, kp = key_tree['swk'][node.id]
                keys['swk'][node.id] = KeySwitchKey(
                    key_q=kq, key_p=kp, level=node.level, sp_level=node.sp_level)
        return keys

    def _seed_env(self, input_arrays, scales):
        env = {}
        data_nodes = self._data_input_nodes()
        for node, arr, scale in zip(data_nodes, input_arrays, scales):
            env[node.index] = _wrap_input(node, arr, scale)
        return env

    def _trace(self, xp, input_arrays, key_tree, scales=None, progress=None):
        data_nodes = self._data_input_nodes()
        default = getattr(self.params, 'scale', 1.0)
        if scales is None:
            scales = [default] * len(data_nodes)
        env = self._seed_env(input_arrays, scales)
        keys = self._build_keys(key_tree)
        for i, step in enumerate(self.plan):
            step(env, xp, keys)
            if progress is not None:
                progress(i + 1)
        # record statically-propagated output scales for this input-scale
        # combination (CKKS: exact scale algebra happens at trace time)
        self._out_scales[tuple(scales)] = [
            getattr(env[o], 'scale', 1.0) for o in self.outputs]
        return [env[o].data for o in self.outputs]

    # ------------------------------------------------------------------
    # Partitioned execution: the reference FPGA runner's compile-time graph
    # partitioning at custom-op barriers (frontend/custom_task.py:2039-2184,
    # fpga/fpga_wrapper.cpp:166-300) — each maximal custom-free span becomes
    # one jitted XLA program ("composite kernel"); custom executors run
    # eagerly on the host between segments, and the segment boundaries are
    # the ABI-bridge host↔device transfers.
    # ------------------------------------------------------------------
    def _segments(self):
        segs, cur = [], []
        for i, meta in enumerate(self.plan_meta):
            if meta['custom'] or meta.get('op') == 'bootstrap':
                if cur:
                    segs.append(('jit', cur))
                    cur = []
                segs.append(('custom' if meta['custom'] else 'btp', [i]))
            else:
                cur.append(i)
        if cur:
            segs.append(('jit', cur))
        return segs

    # A whole bootstrap graph is a very large single program (the n=256
    # toy already took >10 min to compile whole), so partitioned mode
    # lowers each bootstrap node through
    # Bootstrapper.segments(): one jitted XLA program per phase
    # (raise / cts_i / split / evalmod / merge / stc_i / steer), with
    # level/scale metadata propagated by an abstract eval_shape walk —
    # no host compute between phases, only jit boundaries.
    def _run_btp_chunked(self, env, key_tree, meta):
        import jax
        import jax.numpy as jnp
        eng = self.engine
        bs = eng.bootstrapper
        in_ids = [i for i in meta['inputs'] if i in env]
        out_id = next(iter(meta['outputs']))
        ct = env[in_ids[0]]
        input_scale = getattr(ct, 'scale', self.params.scale)
        caller_scale = self.params.scale
        datas = (ct.data,)
        metas = ((ct.level, ct.is_ntt, caller_scale),)
        n_seg = len(bs.segments(caller_scale))

        def make(si, metas_in):
            def g(ds, kt):
                keys = self._build_keys(kt)
                swk = keys.get('swk', {})
                segs = bs.segments(caller_scale, swk.get('swk_dts'),
                                   swk.get('swk_std'))
                cc = tuple(Ciphertext(data=d, level=m[0], is_ntt=m[1],
                                      scale=m[2])
                           for d, m in zip(ds, metas_in))
                out = segs[si][1](jnp, cc, keys['rlk'], keys['glk'])
                g.out_meta = tuple((c.level, c.is_ntt, c.scale)
                                   for c in out)
                return tuple(c.data for c in out)
            return g

        plan_key = ('btp_plan', metas,
                    tuple((d.shape, str(d.dtype)) for d in datas))
        plan = self._jitted.get(plan_key)
        if plan is None:
            plan = self._compile_btp_segments(make, n_seg, metas, datas,
                                              key_tree)
            self._jitted[plan_key] = plan
        for fn, out_metas in plan:
            datas = fn(datas, key_tree)
            metas = out_metas
        out = Ciphertext(data=datas[0], level=metas[0][0], is_ntt=metas[0][1],
                         scale=input_scale)
        env[out_id] = out

    def _compile_btp_segments(self, make, n_seg, metas, datas, key_tree):
        """Ahead-of-time compile of every bootstrap segment -> [(fn,
        out_metas)]. Segments are traced and lowered in order (each needs
        the previous one's output metadata) and each is compiled on a
        worker thread as soon as it is lowered: XLA compiles outside the
        GIL, so the compiles overlap each other and the next trace. The
        wall time is kept in ``last_compile_s``."""
        import jax
        from concurrent.futures import ThreadPoolExecutor
        # const lifting (utils/jit_lift.py): full-size segment HLO
        # embeds 100s of MB of DFT-diagonal/twiddle constants; lifted,
        # they become runtime arguments. Default ON;
        # LATTISENSE_JIT_LIFT=0 turns it off
        lift = os.environ.get('LATTISENSE_JIT_LIFT', '1') not in ('', '0')
        if lift:
            from ..utils.jit_lift import jit_lifted
        sds = lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
        key_sds = jax.tree.map(sds, key_tree)
        in_sds = tuple(sds(d) for d in datas)
        t0 = time.perf_counter()
        pending = []
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
            for si in range(n_seg):
                g = make(si, metas)
                fn = jit_lifted(g) if lift else jax.jit(g)
                lowered = fn.lower(in_sds, key_sds)     # sets g.out_meta
                metas = g.out_meta
                in_sds = tuple(sds(o) for o in lowered.out_info)
                pending.append((pool.submit(lowered.compile), metas))
            plan = [(fut.result(), m) for fut, m in pending]
        self.last_compile_s = time.perf_counter() - t0
        return plan

    def _run_partitioned(self, input_arrays, key_tree, scales, progress=None):
        """Partitioned execution with heterogeneous overlap: custom (host)
        steps run asynchronously in the host thread pool while the main
        thread keeps dispatching device segments — XLA dispatch is itself
        async, so host executors and device compute genuinely overlap; a
        consumer blocks only when it actually reads a pending host output.
        This is the reference scheduler's concurrent routing of on_cpu
        nodes to the CPU pool alongside backend work
        (cpu_task_utils.h:540-546, gpu_wrapper.cu:204-345). Dependencies
        are honored by construction: segments are submitted in topo order
        and the pool dequeues FIFO, so a host job only ever waits on
        earlier-submitted jobs (no deadlock at any pool size)."""
        import jax
        import jax.numpy as jnp
        from concurrent.futures import Future
        env = self._seed_env(input_arrays, scales)
        if self._jitted is None:
            self._jitted = {}
        np_keys = None
        done = 0
        host_jobs = []

        def resolve(i):
            v = env[i]
            if isinstance(v, Future):
                env[i] = v = v.result()   # re-raises host-executor errors
            return v

        for si, (kind, idxs) in enumerate(self._segments()):
            if kind == 'btp':
                for i in self.plan_meta[idxs[0]]['inputs']:
                    if i in env:
                        resolve(i)
                self._run_btp_chunked(env, key_tree, self.plan_meta[idxs[0]])
            elif kind == 'custom':
                meta = self.plan_meta[idxs[0]]
                step = self.plan[idxs[0]]
                if np_keys is None:
                    np_keys = self._build_keys(
                        jax.tree.map(np.asarray, key_tree))
                ins = {i: env[i] for i in meta['inputs'] if i in env}
                outs = {o: Future() for o in meta['outputs']}

                def host_job(_step=step, _ins=ins, _outs=outs,
                             _keys=np_keys):
                    try:
                        sub = {}
                        for i, v in _ins.items():
                            if isinstance(v, Future):
                                v = v.result()
                            # device → host fetch (the ABI bridge hop)
                            # happens in the worker, off the dispatch path
                            sub[i] = jax.tree.map(np.asarray, v)
                        _step(sub, np, _keys)
                        vals = {o: sub[o] for o in _outs}   # all-or-nothing
                        for o, f in _outs.items():
                            f.set_result(vals[o])
                    except BaseException as e:
                        for f in _outs.values():
                            if not f.done():    # never mask the real error
                                f.set_exception(e)
                        raise

                host_jobs.append(self._host_pool().submit(host_job))
                env.update(outs)
            else:
                in_ids = sorted({i for k in idxs
                                 for i in self.plan_meta[k]['inputs']
                                 if i in env})
                for i in in_ids:      # block only on pending host outputs
                    resolve(i)
                out_ids = sorted({o for k in idxs
                                  for o in self.plan_meta[k]['outputs']})
                cache_key = ('seg', si, tuple(scales))
                fn = self._jitted.get(cache_key)
                if fn is None:
                    steps = [self.plan[k] for k in idxs]

                    def seg(sub_env, kt, _steps=steps, _out=tuple(out_ids)):
                        keys = self._build_keys(kt)
                        e = dict(sub_env)
                        for st in _steps:
                            st(e, jnp, keys)
                        return {o: e[o] for o in _out}

                    fn = jax.jit(seg)
                    self._jitted[cache_key] = fn
                env.update(fn({i: env[i] for i in in_ids}, key_tree))
            done += len(idxs)
            if progress is not None:
                progress(done)
        for o in self.outputs:
            resolve(o)
        # surface host-executor failures whose outputs nothing consumed
        for j in host_jobs:
            j.result()
        self._out_scales[tuple(scales)] = [
            getattr(env[o], 'scale', 1.0) for o in self.outputs]
        return [jax.tree.map(np.asarray, env[o]).data
                if hasattr(env[o], 'data') else np.asarray(env[o])
                for o in self.outputs]

    def _context_key_tree(self, context):
        tree = {'rlk': None, 'glk': {}, 'swk': {}}
        needed = self._key_signature_order()
        for i in needed:
            node = self.data[i]
            if node.type == 'rlk':
                tree['rlk'] = (context.rlk.key_q, context.rlk.key_p)
            elif node.type == 'glk':
                k = context.glk.keys[node.galois_element]
                tree['glk'][node.galois_element] = (k.key_q, k.key_p)
            elif node.type == 'swk':
                k = context.swk[node.id]
                tree['swk'][node.id] = (k.key_q, k.key_p)
        return tree

    def preload(self, context, offline_values: dict):
        """Stage the offline-input phase once (reference offline_inputs:
        constant data preloaded before many online runs,
        frontend/custom_task.py:2190-2205). Subsequent run() calls only
        need the online arguments; offline arrays are device-resident."""
        for row in self.signature.get('offline', []):
            if row['id'] not in offline_values:
                raise RuntimeError(f"Missing input argument \"{row['id']}\".")
            check_sig.check_with_sig(row['id'], offline_values[row['id']], row)
        self._offline = dict(offline_values)
        if self.mode == 'jit':
            import jax
            self._offline = jax.tree.map(jax.device_put, self._offline)

    def _adopt_context_word(self, context):
        """Re-bind the task engine onto the caller context's RNS word.

        The serialized parameter blob is word-agnostic (same primes either
        way); a context built on the 32-bit word must execute
        with u32 arrays, so the engine, executor closures, and compiled
        cache are rebuilt once on first word change."""
        wb = getattr(context.params, 'word_bits', 64)
        if wb == self.params.word_bits:
            return
        self.params = params_from_task_json(self.mag['parameter'],
                                            word_bits=wb)
        self.engine = (BfvEngine if self.algo == 'BFV'
                       else CkksEngine)(self.params)
        self._build_plan()
        self._jitted = None
        self._out_scales = {}

    def check(self, context, input_values: dict):
        self._adopt_context_word(context)
        check_sig.check_signatures(context, self.signature, input_values,
                                   [r for r in self.signature['online']
                                    if r['phase'] == 'out'])
        check_sig.check_parameter(context, self.mag['parameter'])

    def run(self, context, input_values: dict, progress_cb=None):
        """Validate, execute, return ({output_id: value}, duration_ns).

        The ns return mirrors FheTaskCpu::run (cxx_fhe_task_cpu.cpp:104) so
        benchmark harnesses compute ops/s identically. ``progress_cb``
        mirrors the reference's throttled ProgressCallback(completed, total)
        (cpu_task_utils.h:414): per-op granularity in eager mode; the jit
        path executes as one fused XLA program, so it reports 0 → total.
        """
        if self._offline:
            input_values = {**self._offline, **input_values}
        self.check(context, input_values)
        # bootstrap precompute lives on the user's context engine
        btp = getattr(context.engine, 'bootstrapper', None)
        if btp is not None:
            self.engine.bootstrapper = btp
        flat_args = self._flatten_args(input_values)
        key_tree = self._context_key_tree(context)
        arrays = [np.asarray(v.data) for v in flat_args]
        default = getattr(self.params, 'scale', 1.0)
        scales = tuple(getattr(v, 'scale', default) for v in flat_args)

        mem_monitor = None
        if os.environ.get('LATTISENSE_DEV', '') not in ('', '0'):
            from ..utils.observability import MemoryMonitor
            mem_monitor = MemoryMonitor(100, with_device=(self.mode == 'jit'))
            mem_monitor.start(MemoryMonitor.next_csv_path('mem_usage_tpu'))

        start = time.perf_counter_ns()
        if self.mode == 'eager':
            if progress_cb is not None:
                total = len(self.plan)
                last = [0.0]

                def wrapped_cb(done):
                    now = time.monotonic()
                    if done >= total or now - last[0] >= 0.1:   # 100 ms throttle
                        last[0] = now
                        progress_cb(done, total)
                out_arrays = self._trace(np, arrays, key_tree, scales,
                                         progress=wrapped_cb)
            else:
                out_arrays = self._trace(np, arrays, key_tree, scales)
        elif self.mode == 'partitioned':
            total = len(self.plan)
            cb = (None if progress_cb is None
                  else (lambda done: progress_cb(done, total)))
            out_arrays = self._run_partitioned(arrays, key_tree, scales,
                                               progress=cb)
        else:
            import jax
            import jax.numpy as jnp
            # scale metadata is static in the traced program: one compiled
            # executable per distinct input-scale combination. Compilation
            # happens OUTSIDE the returned timer: the reference's ns covers
            # graph execution only (cxx_fhe_task_cpu.cpp:62-104).
            if self._jitted is None:
                self._jitted = {}
            if scales not in self._jitted:
                donate = (0,) if self.donate_inputs else ()
                fn = jax.jit(
                    lambda ins, kt, s=scales: self._trace(jnp, ins, kt, s),
                    donate_argnums=donate)
                fn.lower(arrays, key_tree).compile()
                self._jitted[scales] = fn
                start = time.perf_counter_ns()
            if progress_cb is not None:
                progress_cb(0, len(self.plan))
            out_arrays = self._jitted[scales](arrays, key_tree)
            out_arrays = [np.asarray(a) for a in out_arrays]   # block + fetch
            if progress_cb is not None:
                progress_cb(len(self.plan), len(self.plan))
        duration_ns = time.perf_counter_ns() - start
        if mem_monitor is not None:
            mem_monitor.stop()

        # re-wrap outputs per graph metadata, grouped by signature rows;
        # scales come from the trace-time propagation for this combination
        out_scales = self._out_scales.get(
            scales, [getattr(self.params, 'scale', 1.0)] * len(self.outputs))
        out_nodes = [self.data[i] for i in self.outputs]
        flat_out = []
        for node, arr, sc in zip(out_nodes, out_arrays, out_scales):
            v = _wrap_input(node, arr, sc)
            if isinstance(v, Ciphertext):
                v.level = arr.shape[-2] - 1   # shape is ground truth
            flat_out.append(v)
        outputs = {}
        pos = 0
        for row in (r for r in self.signature['online'] if r['phase'] == 'out'):
            cnt = 1
            for s in row['size']:
                cnt *= s
            vals = flat_out[pos:pos + cnt]
            pos += cnt
            outputs[row['id']] = vals[0] if row['size'] == [1] else _reshape(vals, row['size'])
        return outputs, duration_ns

    def compile(self, context, input_values: dict):
        """Ahead-of-time compile (jit lower+compile) without executing."""
        if self.mode != 'jit':
            return
        self._adopt_context_word(context)
        import jax
        import jax.numpy as jnp
        flat_args = self._flatten_args(input_values)
        key_tree = self._context_key_tree(context)
        arrays = [np.asarray(v.data) for v in flat_args]
        default = getattr(self.params, 'scale', 1.0)
        scales = tuple(getattr(v, 'scale', default) for v in flat_args)
        if self._jitted is None:
            self._jitted = {}
        if scales not in self._jitted:
            self._jitted[scales] = jax.jit(
                lambda ins, kt, s=scales: self._trace(jnp, ins, kt, s))
        self._jitted[scales].lower(arrays, key_tree).compile()


def _reshape(flat: list, shape: list):
    if len(shape) <= 1:
        return flat
    step = len(flat) // shape[0]
    return [_reshape(flat[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0])]


# Reference-parity aliases (FheTaskCpu name used in examples/docs)
FheTask = FheTaskTpu
