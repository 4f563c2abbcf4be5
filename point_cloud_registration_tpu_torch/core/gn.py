"""Gauss-Newton loop for SE(3) registration (counterpart of
``point_cloud_registration_tpu/core/gn.py``).

The JAX package compiles the loop into one ``lax.while_loop`` on the device.
Here each kind of caller has one way to run it:

* a single align (the four solvers' ``align``, FastVPlaneICP's two phases):
  :func:`gauss_newton_device` with a :class:`LoopRequest`, through the
  :class:`PreparedLoop` kept in a :class:`LoopSlot` (a solver's, or a fresh
  one for an align with no solver): one launch of a loop kernel
  (``ops/kernels/gn_loop``: the stats, the solve, the update and the
  histories of every iteration, on the card) and one read of the state;
* a batch (``models._fused.fused_voxel_align_batched``,
  ``models._point_fused.fused_point_align_batched``):
  :func:`batched_gauss_newton_device`, one launch of a batched loop kernel
  and one read;
* the multi-device paths (``parallel/``), whose all-reduce runs on the
  host: the host loops :func:`gauss_newton` and
  :func:`batched_gauss_newton` (one copy of the stats to the host per
  iteration, the solve and the update on the host). They are also the plain
  reference that the loop kernels are held to.

The state of the device loops is a :class:`GNState`: each problem's pose,
counters, flags and histories in one buffer on the data's device. On CPU
tensors the loop kernels run their plain versions.

Iteration semantics match the reference exactly (registration.py:89-111):

    for i in range(max_iter):
        H, g, e2 = stats(T)              # solver-specific, fused
        dx = -solve(H, g)                # 6x6
        if ||dx|| < tol: break           # T NOT updated on the breaking step
        T = T boxplus dx

A non-finite ``dx`` ends the loop with ``solver_failed`` set instead of
propagating NaNs (the reference lets ``np.linalg.solve`` raise).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.se3 import plus
from point_cloud_registration_tpu_torch.utils.diagnostics import span

class GNStats(NamedTuple):
    """One linearization: normal equations + bookkeeping.

    ``H`` (6, 6) is ``sum_i w_i J_i^T J_i``, ``g`` (6,) is
    ``sum_i w_i J_i^T r_i``, ``e2`` the weighted squared error and
    ``n_inliers`` the summed weight of the gated correspondences.
    """

    H: torch.Tensor
    g: torch.Tensor
    e2: torch.Tensor
    n_inliers: torch.Tensor


class GNDiagnostics(NamedTuple):
    """Per-align diagnostics; the histories have length ``max_iter``."""

    iterations: int  # number of linearizations performed
    converged: bool  # ||dx|| < tol reached
    solver_failed: bool  # non-finite update encountered
    e2_history: torch.Tensor  # (max_iter,) f32, 0 past the last iteration
    dx_norm_history: torch.Tensor  # (max_iter,) f32
    inlier_history: torch.Tensor  # (max_iter,) i32
    final_e2: float


def packed_from_stats(stats: GNStats) -> torch.Tensor:
    """GNStats -> the (29,) layout of the stats kernels' output:
    ``[H upper triangle, row-major (21) | g (6) | e2 | n_inliers]``."""
    triu = torch.triu_indices(6, 6, device=stats.H.device)  # made there: no copy, no wait
    return torch.cat([
        stats.H[triu[0], triu[1]],
        stats.g.reshape(6),
        stats.e2.reshape(1),
        stats.n_inliers.reshape(1),
    ])


def stats_from_packed(packed: torch.Tensor) -> GNStats:
    """The (..., 29) kernel output -> GNStats (H symmetric) with the same
    leading dims, on its device: (29,) gives one problem's, (B, 29) B
    problems' stats."""
    triu = torch.triu_indices(6, 6, device=packed.device)
    H = torch.zeros(packed.shape[:-1] + (6, 6), dtype=packed.dtype, device=packed.device)
    H[..., triu[0], triu[1]] = packed[..., :21]
    H[..., triu[1], triu[0]] = packed[..., :21]
    return GNStats(H=H, g=packed[..., 21:27], e2=packed[..., 27], n_inliers=packed[..., 28])


def step_norm(dx: torch.Tensor) -> torch.Tensor:
    """``||dx||`` over the last axis, (..., 6) -> (...): the sum of squares
    in order, then the square root, each operation rounded once in the
    input's dtype. The loop kernels' update (``csrc/gn_step.cuh``) forms
    the same number bit for bit; the gate ``||dx|| < tol`` decides the
    iteration count."""
    acc = dx[..., 0] * dx[..., 0]
    for k in range(1, dx.shape[-1]):
        acc = acc + dx[..., k] * dx[..., k]
    return torch.sqrt(acc)


def solve_6x6_batched(H, g) -> np.ndarray:
    """Solve ``H[b] dx[b] = -g[b]`` for B problems at once, on the host:
    ``H`` (B, 6, 6) and ``g`` (B, 6), tensors or arrays -> (B, 6) float32 NumPy.

    The unrolled scalar Cholesky of the JAX package after Jacobi (diagonal)
    scaling, in float32 with the same operation order, each scalar step an
    elementwise NumPy operation over the B problems (the counterpart of
    ``jax.vmap(solve_6x6)``). Every step rounds once per element, so row b is
    the single solve of problem b, bit for bit. A singular H yields NaNs in
    its row (never an exception).
    """
    Hn = np.asarray(torch.as_tensor(H).detach().to("cpu", torch.float32))
    gn = np.asarray(torch.as_tensor(g).detach().to("cpu", torch.float32))
    one = np.float32(1.0)
    with np.errstate(all="ignore"):
        s = one / np.sqrt(np.maximum(np.diagonal(Hn, axis1=1, axis2=2), np.float32(1e-30)))
        Hs = Hn * s[:, :, None] * s[:, None, :]
        b = -(gn * s)

        # Unrolled Cholesky factorization Hs = L L^T.
        L = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(i + 1):
                acc = Hs[:, i, j]
                for k in range(j):
                    acc = acc - L[i][k] * L[j][k]
                if i == j:
                    L[i][j] = np.sqrt(acc)
                else:
                    L[i][j] = acc / L[j][j]
        # Forward substitution L y = b.
        y = [None] * 6
        for i in range(6):
            acc = b[:, i]
            for k in range(i):
                acc = acc - L[i][k] * y[k]
            y[i] = acc / L[i][i]
        # Back substitution L^T x = y.
        x = [None] * 6
        for i in reversed(range(6)):
            acc = y[i]
            for k in range(i + 1, 6):
                acc = acc - L[k][i] * x[k]
            x[i] = acc / L[i][i]
        return np.stack(x, axis=1).astype(np.float32) * s


def solve_6x6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H dx = -g`` for the GN step (registration.py:103), on the host:
    :func:`solve_6x6_batched` of the one problem. H is symmetric PSD by
    construction; a singular H yields NaNs (never an exception), which the
    GN loop reports as ``solver_failed``. Returns a float32 CPU tensor.
    """
    H = torch.as_tensor(H).reshape(1, 6, 6)
    g = torch.as_tensor(g).reshape(1, 6)
    return torch.from_numpy(solve_6x6_batched(H, g)[0])


def gauss_newton(
    stats_fn: Callable[[torch.Tensor], GNStats],
    init_T,
    max_iter: int,
    tol: float,
) -> tuple[torch.Tensor, GNDiagnostics]:
    """The host loop: returns ``(T (4, 4) f32 CPU tensor, diagnostics)``.

    ``stats_fn(T) -> GNStats`` encapsulates everything solver-specific
    (correspondence + linearization + reduction). It receives T as a
    float32 CPU tensor and returns the stats on the host, copied there in
    one transfer (stats left on a device still work, at one sync each).
    """
    T = torch.as_tensor(init_T).to("cpu", torch.float32).clone()
    e2_hist = torch.zeros(max_iter, dtype=torch.float32)
    dxn_hist = torch.zeros(max_iter, dtype=torch.float32)
    inl_hist = torch.zeros(max_iter, dtype=torch.int32)
    it = 0
    done = failed = converged = False
    final_e2 = 0.0
    while it < max_iter and not done:
        stats = stats_fn(T)
        dx = solve_6x6(stats.H, stats.g)
        dx_norm = step_norm(dx)
        bad = not bool(torch.isfinite(dx_norm))
        converged_now = bool(dx_norm < tol)
        done = converged_now or bad
        # Reference ordering: the transform is NOT updated on the breaking step.
        if not done:
            T = plus(T, dx)
        failed = failed or bad
        converged = converged or converged_now
        e2_hist[it] = stats.e2.to(torch.float32)
        dxn_hist[it] = dx_norm
        inl_hist[it] = stats.n_inliers.to(torch.int32)
        final_e2 = float(stats.e2)
        it += 1
    diag = GNDiagnostics(
        iterations=it,
        converged=converged,
        solver_failed=failed,
        e2_history=e2_hist,
        dx_norm_history=dxn_hist,
        inlier_history=inl_hist,
        final_e2=final_e2,
    )
    return T, diag


def batched_gauss_newton(stats_all: Callable[[torch.Tensor], GNStats], init_Ts,
                         max_iter: int, tol: float) -> tuple[torch.Tensor, GNDiagnostics]:
    """The host loop of B problems at once (``batched_gauss_newton`` of the
    JAX package, models/_fused.py:288-355).

    ``stats_all(Ts)`` takes the (B, 4, 4) float32 CPU transforms and returns
    GNStats with leading dim B on the host, from one transfer. Per
    iteration: every problem's stats, the batched solve, then for each
    problem the check and the update, with each problem's semantics of
    :func:`gauss_newton`: T frozen on its breaking step and once it is
    done; its iteration count advancing while it is active; done when it
    converges, fails or reaches ``max_iter``; its flags, histories (written
    at ``clip(it, 0, max_iter - 1)``) and ``final_e2`` changed only while it
    is active. The loop ends when every problem is done. A problem's solve,
    step norm and update are those of its single loop, bit for bit.

    Returns ``(Ts (B, 4, 4) f32 CPU tensor, GNDiagnostics)``: the same
    fields as a single align's, each with a leading dim B as CPU tensors:
    ``iterations`` (B,) int32, ``converged`` and ``solver_failed`` (B,)
    bool, the histories (B, max_iter), ``final_e2`` (B,) float32.
    """
    T = torch.as_tensor(init_Ts).to("cpu", torch.float32).clone()
    B = T.shape[0]
    rows = torch.arange(B)
    it = torch.zeros(B, dtype=torch.int32)
    done = torch.full((B,), max_iter <= 0)
    failed = torch.zeros(B, dtype=torch.bool)
    converged = torch.zeros(B, dtype=torch.bool)
    e2_hist = torch.zeros((B, max_iter), dtype=torch.float32)
    dxn_hist = torch.zeros((B, max_iter), dtype=torch.float32)
    inl_hist = torch.zeros((B, max_iter), dtype=torch.int32)
    final_e2 = torch.zeros(B, dtype=torch.float32)
    while not bool(done.all()):
        active = ~done
        stats = stats_all(T)
        dx = torch.from_numpy(solve_6x6_batched(stats.H, stats.g))
        dx_norm = step_norm(dx)
        bad = ~torch.isfinite(dx_norm)
        conv_now = dx_norm < tol
        done_now = conv_now | bad
        # the transform is NOT updated on the breaking step, nor once done
        for b in torch.nonzero(~(done | done_now)).flatten().tolist():
            T[b] = plus(T[b], dx[b])
        e2 = stats.e2.to(torch.float32)
        at = it.clamp(0, max_iter - 1).long()
        for hist, v in ((e2_hist, e2), (dxn_hist, dx_norm),
                        (inl_hist, stats.n_inliers.to(torch.int32))):
            hist[rows[active], at[active]] = v[active]
        it = it + active.to(torch.int32)
        failed |= active & bad
        converged |= active & conv_now
        final_e2 = torch.where(active, e2, final_e2)
        done = done | (active & done_now) | (it >= max_iter)
    diag = GNDiagnostics(
        iterations=it,
        converged=converged,
        solver_failed=failed,
        e2_history=e2_hist,
        dx_norm_history=dxn_hist,
        inlier_history=inl_hist,
        final_e2=final_e2,
    )
    return T, diag


class GNState(NamedTuple):
    """The resident state of B problems; every field is a view of ``words``,
    one int32 buffer, so that one copy brings all of it to the host:

        poses (B, 12) f32 [R row-major | t] | it | done | failed | converged
        (B,) i32 | final_e2 (B,) f32 | e2 (B, M) f32 | dx_norm (B, M) f32 |
        inliers (B, M) i32

    with ``M = max_iter``. ``poses`` is the layout the stats kernels read."""

    words: torch.Tensor  # (17 B + 3 B M,) int32
    poses: torch.Tensor  # (B, 12) f32
    it: torch.Tensor  # (B,) i32: iterations run
    done: torch.Tensor  # (B,) i32: 0 while the problem iterates
    failed: torch.Tensor  # (B,) i32
    converged: torch.Tensor  # (B,) i32
    final_e2: torch.Tensor  # (B,) f32
    e2: torch.Tensor  # (B, M) f32
    dx_norm: torch.Tensor  # (B, M) f32
    inliers: torch.Tensor  # (B, M) i32


def _fields(words: torch.Tensor, B: int, M: int) -> GNState:
    f32 = torch.float32
    ends = [12 * B, 13 * B, 14 * B, 15 * B, 16 * B, 17 * B, 17 * B + B * M, 17 * B + 2 * B * M,
            17 * B + 3 * B * M]
    a = [0] + ends
    return GNState(
        words=words,
        poses=words[a[0]:a[1]].view(f32).view(B, 12),
        it=words[a[1]:a[2]],
        done=words[a[2]:a[3]],
        failed=words[a[3]:a[4]],
        converged=words[a[4]:a[5]],
        final_e2=words[a[5]:a[6]].view(f32),
        e2=words[a[6]:a[7]].view(f32).view(B, M),
        dx_norm=words[a[7]:a[8]].view(f32).view(B, M),
        inliers=words[a[8]:a[9]].view(B, M),
    )


def pose_rows_of(Ts) -> torch.Tensor:
    """(B, 4, 4) transforms -> (B, 12) float32 pose rows [R row-major | t],
    on the transforms' device."""
    Ts = torch.as_tensor(Ts, dtype=torch.float32)
    B = Ts.shape[0]
    return torch.cat([Ts[:, :3, :3].reshape(B, 9), Ts[:, :3, 3]], dim=1)


def transforms_of(poses: torch.Tensor) -> torch.Tensor:
    """(B, 12) pose rows -> (B, 4, 4) transforms (last row [0, 0, 0, 1]), on
    their device, with no copy from the host."""
    B = poses.shape[0]
    T = torch.zeros((B, 4, 4), dtype=poses.dtype, device=poses.device)
    T[:, :3, :3] = poses[:, :9].reshape(B, 3, 3)
    T[:, :3, 3] = poses[:, 9:12]
    T[:, 3, 3] = 1.0
    return T


def new_state(init_Ts, max_iter: int, device) -> GNState:
    """The state of B problems at ``init_Ts`` (B, 4, 4), before their first
    iteration, on ``device``: zero counters, flags and histories, ``done``
    set when ``max_iter <= 0``. The buffer is filled on the host and goes to
    a card in one copy from pinned memory, which does not wait for the card."""
    device = torch.device(device)
    Ts = torch.as_tensor(init_Ts).to("cpu", torch.float32)
    B, M = Ts.shape[0], max(int(max_iter), 0)
    words = torch.zeros(17 * B + 3 * B * M, dtype=torch.int32,
                        pin_memory=device.type == "cuda")
    host = _fields(words, B, M)
    host.poses.copy_(pose_rows_of(Ts))
    host.done.fill_(int(max_iter <= 0))
    if device.type == "cpu":
        return host
    return _fields(words.to(device, non_blocking=True), B, M)


def read_state(state: GNState) -> GNState:
    """The state on the host: one copy (a CPU state is returned as it is)."""
    B, M = state.e2.shape
    return _fields(state.words.to("cpu"), B, M)


# A pose row [R row-major | t] as indices into a flat (16,) transform.
_POSE_AT = np.array([0, 1, 2, 4, 5, 6, 8, 9, 10, 3, 7, 11])
_EYE16 = np.eye(4, dtype=np.float32).reshape(16)


class PreparedLoop:
    """One problem's whole-loop align made once and refilled by every align
    after it: the state's words on the device with their views, a pinned
    init buffer (zero but the pose rows), a pinned read buffer and its NumPy
    views, and the loop's launch with every argument bound but the scan's
    (``prepare(state, src, w)``: a looper of ``ops/kernels/gn_loop``, whose
    ``run(src, w)`` launches the loop on another scan of the same length).

    An align (:meth:`start`, :meth:`finish`, :meth:`result`) writes the pose
    into the init buffer, copies it to the words in one copy that does not
    wait (zero counters, flags and histories, as :func:`new_state` makes
    them), launches the loop, and copies the words back to the read buffer
    in one copy that waits for the card; ``T`` and the diagnostics are
    copies of the read buffer. The plan serves ``max_iter >= 1`` on the CPU
    (its plain loop, the copies plain) or a card, on the stream current when
    it is made. ``PreparedLoop.builds`` and ``PreparedLoop.reuses`` count
    the plans made and the aligns that found one."""

    builds = 0
    reuses = 0

    def __init__(self, key: tuple, targets: tuple, max_iter: int, device: torch.device,
                 prepare: Callable, src: torch.Tensor, w: torch.Tensor):
        self.key, self.targets = key, targets
        M = int(max_iter)
        card = device.type == "cuda"
        words = dict(size=(17 + 3 * M,), dtype=torch.int32)
        self.init = torch.zeros(**words, pin_memory=card)
        self.pose = _fields(self.init, 1, M).poses.numpy()
        self.words = torch.zeros(**words, device=device)
        self.read = torch.zeros(**words, pin_memory=card)
        self.host = GNState(*(x.numpy() for x in _fields(self.read, 1, M)))
        self.stream = torch.cuda.current_stream(device) if card else None
        # recorded after each copy from ``init``: an align that raised may leave one in flight
        self.sent = torch.cuda.Event() if card else None
        self.in_flight = False
        self.launch = prepare(_fields(self.words, 1, M), src, w)

    def matches(self, key: tuple, targets: tuple) -> bool:
        return self.key == key and len(targets) == len(self.targets) and all(
            a is b for a, b in zip(targets, self.targets))

    def start(self, init_T, src: torch.Tensor, w: torch.Tensor) -> None:
        """The state at ``init_T`` on the device and the loop launched on ``src``."""
        if self.in_flight:
            self.sent.synchronize()
        T = torch.as_tensor(init_T).detach().to("cpu", torch.float32)
        self.pose[0] = T.numpy().reshape(16)[_POSE_AT]
        self.words.copy_(self.init, non_blocking=True)
        if self.sent is not None:
            self.sent.record(self.stream)
            self.in_flight = True
        self.launch.run(src, w)

    def finish(self) -> None:
        """The state in the read buffer: one copy, which waits for the card."""
        self.read.copy_(self.words)
        self.in_flight = False

    def result(self) -> tuple[torch.Tensor, GNDiagnostics]:
        """``(T (4, 4) float32, diagnostics)`` of the read buffer, copied."""
        h = self.host
        T = _EYE16.copy()
        T[_POSE_AT] = h.poses[0]
        return torch.from_numpy(T.reshape(4, 4)), GNDiagnostics(
            iterations=int(h.it[0]),
            converged=bool(h.converged[0]),
            solver_failed=bool(h.failed[0]),
            e2_history=torch.from_numpy(h.e2[0].copy()),
            dx_norm_history=torch.from_numpy(h.dx_norm[0].copy()),
            inlier_history=torch.from_numpy(h.inliers[0].copy()),
            final_e2=float(h.final_e2[0]),
        )


class LoopSlot:
    """Where a solver keeps its :class:`PreparedLoop` (``plan``, None until
    an align makes one): one at a time, dropped with the target."""

    def __init__(self):
        self.plan: PreparedLoop | None = None

    def align(self, req: "LoopRequest", init_T, max_iter: int, device: torch.device,
              ) -> tuple[torch.Tensor, GNDiagnostics]:
        """:func:`gauss_newton_device`'s result for ``req`` from ``init_T``,
        through the slot's plan, made first when none fits. Under a profiler
        the making is the span ``pcr.gn.plan``, inside ``pcr.gn.setup``."""
        with span("pcr.gn.setup"):
            stream = (torch.cuda.current_stream(device).cuda_stream if device.type == "cuda"
                      else None)
            key = (req.key, req.src.shape[0], int(max_iter), device, stream)
            plan = self.plan
            if plan is not None and plan.matches(key, req.targets):
                PreparedLoop.reuses += 1
            else:
                self.plan = None
                with span("pcr.gn.plan"):
                    plan = PreparedLoop(key, req.targets, max_iter, device, req.prepare,
                                        req.src, req.w)
                self.plan = plan
                PreparedLoop.builds += 1
            plan.start(init_T, req.src, req.w)
        with span("pcr.gn.read"):
            plan.finish()
        return plan.result()


class LoopRequest(NamedTuple):
    """An align of ``src`` through ``slot``'s plan, as :func:`gauss_newton_device`
    takes it for ``loop``: the plan is made anew (``prepare``) unless it was
    made for the same ``targets`` (each the same object), an equal ``key``
    (the solver's kind and settings), the scan's length, ``max_iter``, the
    device and its current stream."""

    slot: LoopSlot
    key: tuple
    targets: tuple
    src: torch.Tensor
    w: torch.Tensor
    prepare: Callable


def gauss_newton_device(loop: LoopRequest, init_T, max_iter: int, device,
                        ) -> tuple[torch.Tensor, GNDiagnostics]:
    """One problem's loop on ``device``: the semantics of :func:`gauss_newton`,
    whose result it returns in the same form, for the align ``loop``
    describes. The whole loop runs in one call on the state
    (``ops/kernels/gn_loop``: one launch of a loop kernel, its plain version
    on the CPU) through the slot's :class:`PreparedLoop` (made there when it
    has none that fits), which is then read once. ``max_iter <= 0`` returns
    the initial state and makes no plan."""
    if max_iter <= 0:
        s = new_state(torch.as_tensor(init_T).reshape(1, 4, 4), max_iter, "cpu")
        return transforms_of(s.poses)[0], GNDiagnostics(
            iterations=0, converged=False, solver_failed=False, e2_history=s.e2[0],
            dx_norm_history=s.dx_norm[0], inlier_history=s.inliers[0], final_e2=0.0)
    return loop.slot.align(loop, init_T, max_iter, torch.device(device))


def batched_gauss_newton_device(loop: Callable[[GNState], None], init_Ts, max_iter: int,
                                device) -> tuple[torch.Tensor, GNDiagnostics]:
    """The loop of B problems on ``device``: the semantics and the result of
    :func:`batched_gauss_newton`. ``loop`` runs every iteration of all B
    problems in one call on the state (``ops/kernels/gn_loop.fused_loop_batched``,
    ``point_loop_batched``: one launch), a problem that is done left as it
    is; the state is then read once. Under a profiler the state's making and
    the launch are the span ``pcr.gn.setup``, the read with its wait for the
    card ``pcr.gn.read``."""
    if max_iter <= 0:
        s = new_state(init_Ts, max_iter, "cpu")
    else:
        with span("pcr.gn.setup"):
            state = new_state(init_Ts, max_iter, device)
            loop(state)
        with span("pcr.gn.read"):
            s = read_state(state)
    diag = GNDiagnostics(
        iterations=s.it.clone(),
        converged=s.converged.to(torch.bool),
        solver_failed=s.failed.to(torch.bool),
        e2_history=s.e2.clone(),
        dx_norm_history=s.dx_norm.clone(),
        inlier_history=s.inliers.clone(),
        final_e2=s.final_e2.clone(),
    )
    return transforms_of(s.poses), diag
