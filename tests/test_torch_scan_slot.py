"""The scan slot of a solver's aligns on a card (``models.base.ScanSlot``, kept
in ``Registration._scan``): a host buffer (pinned for a card) whose rows past
the scan stay zero, the scan and its 0/1 weights on the device, and an event
recorded after each copy from the host buffer, made once a padded length,
device and stream and refilled by every align after it.

Its ``(src, w)`` are held bit for bit to ``pad_points``'s: lengths on both
sides of a bucket's edge, NumPy float32 and float64 (the cast to float32 in
the slot's one host copy), CPU tensors and arrays that are not C-ordered; a
scan that shrinks inside its bucket; a tensor that requires grad, which the
slot leaves to ``pad_points``; and, with tensors that report a card
(``test_torch_gn_loop_batched.py``'s ``FakeCard``), scans on the card copied
there and host scans in turn. The CPU aligns of VPlaneICP, NDT and PlaneICP on
the slot's tensors are their aligns on ``pad_points``'s, bit for bit; on a
faked card a solver's aligns launch their loop on the slot's buffers, and an
align after one that raised waits for a copy still in flight. The slot on the
card is ``test_torch_gn_plan_card.py``'s.
"""

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.models import ScanSlot, pad_points
from oracles import make_scan, make_scene
from test_torch_gn_loop_batched import CARD, OnCard, _to_card
from test_torch_gn_plan import Event, card  # noqa: F401  (the faked card's fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LENGTHS = [1, 8191, 8192, 8193, 100_000]
KINDS = ["float32", "float64", "tensor", "fortran", "fortran64", "strided", "tensor64"]
CPU = torch.device("cpu")


def _points(n: int, kind: str, seed: int = 0):
    """``n`` scan points of ``kind``, drawn in float64: the cast to float32 rounds."""
    x = np.random.RandomState(seed).randn(2 * n, 3) * 37.0
    return {"float32": lambda: x[:n].astype(np.float32),
            "float64": lambda: x[:n],
            "tensor": lambda: torch.from_numpy(x[:n].astype(np.float32)),
            "fortran": lambda: np.asfortranarray(x[:n].astype(np.float32)),
            "fortran64": lambda: np.asfortranarray(x[:n]),
            "tensor64": lambda: torch.from_numpy(x[::2]),
            "strided": lambda: x.astype(np.float32)[::2]}[kind]()


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(torch.Tensor) if isinstance(x, OnCard) else x


def _same(got, want) -> None:
    """Two ``(src, w)`` pairs bit for bit."""
    for a, b in zip(got, want):
        a, b = _plain(a), _plain(b)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _counts():
    return ScanSlot.builds, ScanSlot.reuses


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_slot_is_pad_points_bit_for_bit(n, kind):
    points = _points(n, kind)
    if kind in ("fortran", "fortran64", "strided") and n > 1:  # one row is both orders
        assert not points.flags.c_contiguous and points.shape == (n, 3)
    slot = ScanSlot.take(None, n, CPU)
    got = slot.fill(torch.as_tensor(points))
    _same(got, pad_points(points, device="cpu"))
    assert got[0] is slot.src and got[1] is slot.w
    again = ScanSlot.take(slot, n, CPU)
    assert again is slot
    _same(slot.fill(torch.as_tensor(points)), pad_points(points, device="cpu"))


def test_the_slot_leaves_other_inputs_to_pad_points(card):
    """On a faked card a solver pads through its slot only a scan the slot
    takes: (N, 3), N >= 1, outside autograd; the others as ``pad_points``."""
    s = pt.VPlaneICP(device=CARD)
    for odd in [torch.zeros((5, 3), requires_grad=True), np.zeros((0, 3), np.float32)]:
        assert not ScanSlot.fits(torch.as_tensor(odd))
        _same(s._upload(odd), pad_points(odd.detach() if torch.is_tensor(odd) else odd,
                                         device="cpu"))
    with pytest.raises(RuntimeError):
        s._upload(np.zeros((5, 2), np.float32))  # as pad_points refuses it
    assert s._scan is None
    scan = _points(10, "float32")
    assert ScanSlot.fits(torch.as_tensor(scan))
    _same(s._upload(scan), pad_points(scan, device="cpu"))
    assert s._scan is not None


def test_a_shorter_scan_in_its_bucket_leaves_zero_rows_and_its_weights():
    builds, reuses = _counts()
    slot = None
    for n in [8000, 5000, 7000, 1, 8192, 6000]:
        points = _points(n, "float64", seed=n)
        slot = ScanSlot.take(slot, n, CPU)
        src, w = slot.fill(torch.as_tensor(points))
        _same((src, w), pad_points(points, device="cpu"))
        assert src.shape == (8192, 3) and not src[n:].any() and not slot.host[n:].any()
        assert bool((w[:n] == 1).all()) and not w[n:].any()
    assert _counts() == (builds + 1, reuses + 5)


def test_a_new_bucket_makes_a_new_slot_and_a_repeated_length_reuses_it():
    builds, reuses = _counts()
    a = ScanSlot.take(None, 100, CPU)
    assert ScanSlot.take(a, 100, CPU) is a and ScanSlot.take(a, 8000, CPU) is a
    b = ScanSlot.take(a, 9000, CPU)
    assert b is not a and b.src.shape == (16384, 3)
    c = ScanSlot.take(b, 100, CPU)
    assert c is not b and c.src.shape == (8192, 3)
    assert _counts() == (builds + 3, reuses + 2)


def test_card_scans_and_host_scans_in_turn(card):
    """On a faked card: a host scan goes through the host buffer in one copy
    (the event recorded), a scan on the card is copied there (no event);
    each, in any order and length, is ``pad_points``'s bit for bit."""
    _, streams, _ = card
    slot = None
    records = 0
    for n, on_card in [(8000, False), (5000, True), (7000, True), (3000, False),
                       (8100, True), (6000, False), (6000, True)]:
        points = torch.from_numpy(_points(n, "float64", seed=n))
        slot = ScanSlot.take(slot, n, CARD)
        src, w = slot.fill(_to_card(points) if on_card else points)
        assert isinstance(src, OnCard) and isinstance(w, OnCard)
        _same((src, w), pad_points(points, device="cpu"))
        records += not on_card
        assert slot.sent.records == [streams[7]] * records and slot.sent.waits == 0
    assert len(Event.made) == 1


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5)).astype(np.float32)


@pytest.fixture(scope="module")
def scans(scene):
    """Two scans in one bucket, the second shorter."""
    return [make_scan(np.random.RandomState(30 + i), scene, np.array(dx), n_points=n)[0]
            for i, (dx, n) in enumerate([([0.05, -0.04, 0.08, 0.01, -0.008, 0.012], 1500),
                                         ([-0.03, 0.06, -0.05, -0.006, 0.01, -0.004], 1200)])]


SOLVERS = {"vplane": pt.VPlaneICP, "ndt": pt.NDT, "plane_icp": pt.PlaneICP}


@pytest.fixture(scope="module")
def solvers(scene):
    out = {}
    for name, cls in SOLVERS.items():
        out[name] = cls(max_iter=12, device="cpu")
        out[name].set_target(scene)
    return out


def _bits(x):
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_cpu_align_on_the_slot_is_the_align_on_pad_points(solvers, scans, name):
    """The solver's align on the slot's tensors, two scans in turn through
    one slot (the second shorter), against its align (which pads with ``pad_points`` on the CPU
    and keeps no slot): T and every diagnostic bit for bit."""
    s = solvers[name]
    slot = None
    for scan in scans:
        slot = ScanSlot.take(slot, scan.shape[0], CPU)
        got = s._align_fn(s._target, *slot.fill(torch.as_tensor(scan)), torch.eye(4))
        T = s.align(scan)
        d = s.last_diagnostics
        assert s._scan is None
        np.testing.assert_array_equal(got.T.numpy().astype(np.float64), T)
        for f in d._fields:
            x, y = getattr(got.diagnostics, f), getattr(d, f)
            assert torch.equal(_bits(x), _bits(y)) if isinstance(x, torch.Tensor) else x == y, f
        assert 2 <= d.iterations and not d.solver_failed


def _card_solver(solvers, name):
    s = SOLVERS[name](max_iter=12, device=CARD)
    s._target = _to_card(solvers[name]._target)
    return s


@pytest.mark.parametrize("name", ["vplane", "plane_icp"])
def test_card_align_launches_on_the_slot_buffers(solvers, scans, card, name):
    """Every align of a solver on a faked card launches its loop on the same
    two buffers of its one slot; a host scan records the slot's event each
    align, which no align waits for; a scan on the card records nothing."""
    log, streams, _ = card
    s = _card_solver(solvers, name)
    builds, reuses = _counts()
    for scan in scans + scans[:1]:
        s.align(scan)
        slot = s._scan
        at = s._loop.plan.launch.scan_at
        assert log[-1][2][at:at + 3] == (slot.src.data_ptr(), slot.w.data_ptr(), 8192)
        _same((slot.src, slot.w), pad_points(scan, device="cpu"))
    assert _counts() == (builds + 1, reuses + 2)
    assert slot.sent.records == [streams[7]] * 3 and slot.sent.waits == 0
    s.align(_to_card(torch.from_numpy(scans[1])))
    assert s._scan is slot and len(slot.sent.records) == 3
    _same((slot.src, slot.w), pad_points(scans[1], device="cpu"))


def test_card_align_after_one_that_raised_waits_for_its_copy(solvers, scans, card):
    """A launch that fails leaves the scan's copy possibly in flight: the
    next align waits for it before it writes the host buffer (only then),
    and fills the slot anew."""
    log, _, current = card
    s = _card_solver(solvers, "ndt")
    s.align(scans[0])
    slot = s._scan
    current["fail"] = True
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        s.align(scans[1])
    slot.sent.ran = False  # that copy has not run yet
    s.align(scans[0])
    assert slot.sent.waits == 1 and s._scan is slot
    slot.sent.ran = True
    s.align(scans[1])
    assert slot.sent.waits == 1 and len(slot.sent.records) == 4
    _same((slot.src, slot.w), pad_points(scans[1], device="cpu"))
