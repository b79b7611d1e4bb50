"""GRU recurrence: forward (K1) and backward (K2, K3) CUDA kernels, their
plain versions, and the autograd Function that joins them.

Replaces the Pallas TPU kernels of `factorvae_tpu/ops/pallas/gru.py`
(`gru_scan`): `_fwd_kernel` (K1, `csrc/gru_fwd.cu`) and the two backward
kernels `_bwd_kernel` (K2, T <= 24) and `_bwd_seg_kernel` (K3, T > 24),
which one CUDA path serves at every T (`csrc/gru_bwd.cu`). Each source's
header comment says what bounds the kernel on an H100 and how its design
meets it.

Wrappers, each with its own launch count:

- `gru_fwd`: the last hidden state (serving and validation).
- `gru_fwd_residuals`: the same recurrence that also returns the residuals
  the backward walk reads: h before each step and g = h . Wh + b of each
  step.
- `gru_bwd`: the walk back through time (dxi, and dg_n, the one block where
  dg differs from dxi), then `gru_dwh`; without residuals it first runs
  `gru_fwd_residuals`.
- `gru_dwh`: dWh and db, summed over every row and step (on the tensor
  cores above H = 64).

`gru_fwd_op` is `gru_fwd` registered as the op
`factorvae_tpu_torch::gru_fwd` (`torch.library.custom_op`), which
`torch.export` records in an exported program's graph.

Each launches its kernel for CUDA tensors and runs its plain version
(`*_plain`) for CPU tensors; there is no fallback between the two. `gru` is
the differentiable recurrence: forward K1 (the residual variant when a
gradient will be needed), backward the walk and `gru_dwh`. Each takes
bfloat16 inputs too and upcasts them (`ops.kernels.upcast`): the kernels
compute in float32 and return float32, as the Pallas kernels do. A float32
input's gradient leaves `gru` unrounded, so a mixed training step feeds
the bfloat16-valued float32 weights of `train/state.cast_compute`.

Up to H = 64 both recurrence kernels launch at the shapes of one rule
(`launch_shape`). Above it each has its own: `fwd_launch_shape` for the
wide forward and `walk_launch_shape` for the wide walk, both persistent
clusters that keep their slices of Wh across row tiles, both weighing the
clusters the card holds at once.

Lanes (the fleets of `train/fleet.py`): every wrapper also takes S models
at once, each array with a leading lane axis (xi (S, N, T, 3H), w_h (S, H,
3H), b_h (S, 3H), dh (S, N, H), ...), in one launch that counts once; the
plain versions run lane by lane. `gru` carries a `torch.func.vmap` rule: a
vmapped call becomes one lane-axis call on the unwrapped (S, ...) tensors,
so ordinary autograd runs through a vmapped forward and its backward is one
lane-axis walk and one dWh launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from factorvae_tpu_torch import _build
from factorvae_tpu_torch.ops.kernels import lane_major, launch_range, plain, upcast

TILE_ROWS = (16, 8)      # rows per tile the kernels take up to H = 64, preferred first
CLUSTERS = (1, 2, 4, 8)  # CTAs per cluster the kernels take (8 only above H = 64)
MAX_UNITS = 64           # hidden units a CTA owns at most (`kMaxUnits`)
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use on an H100
_THREADS = 192           # threads per CTA (`kThreads`)
# The forward above H = 64 (csrc/gru_fwd.cu, "The wide forward"): row tiles
# it is launched with, at most WIDE_UNITS units a CTA, and the fixed part
# of a step's cost (the barriers, the gates, splitting Wh's fragments) in
# rows of a tile, fit to the step times of scripts/torch_gru_fwd_probe.py
# at H = 256 on an H100.
FWD_ROWS = (64, 32, 16)
WIDE_UNITS = 32
STEP_FIXED_ROWS = 32
# The walk above H = 64 (csrc/gru_bwd.cu, "The wide walk"): its row tiles,
# and the fixed part of its step's cost in rows of a tile (the gates, the
# barriers, the DSMEM sum), fit to scripts/torch_gru_walk_probe.py's tile
# times at H = 128 and 256 on an H100.
WALK_ROWS = (32, 24, 16)
WALK_STEP_FIXED_ROWS = 48


def _mma_ld(k: int) -> int:
    return ((k + 7) & ~7) + 4


def _round16(x: int) -> int:
    return (x + 15) & ~15


def fwd_smem_bytes(h_dim: int, rows: int, cluster: int) -> int:
    """K1's dynamic shared memory at a launch shape (`gru_fwd_smem_bytes`
    of csrc/gru_fwd.cu): up to H = 64 `fwd_smem_floats` (a CTA's Wh^T slice,
    h, xi and the product's partial sums), above it `wide_smem_floats` (the
    Wh slice in groups of 16 units, h^T of the tile and an mbarrier). A
    copy of those layouts, so that the rule runs without a library; a cuda
    test holds it to the library's at every shape."""
    umax = -(-h_dim // cluster)
    k = (h_dim + 7) & ~7
    if h_dim > MAX_UNITS:
        return 4 * (k * (48 * -(-umax // 16) + 8 + (rows | 8)) + 2)
    nbuf = 2 if cluster > 1 else 1
    return 4 * (nbuf * rows * _mma_ld(h_dim) + _round16(3 * umax) * _mma_ld(h_dim)
                + rows * _THREADS + nbuf * rows * 3 * umax + 3 * umax)


def walk_smem_bytes(h_dim: int, rows: int, cluster: int) -> int:
    """The walk's dynamic shared memory at a launch shape
    (`gru_walk_smem_bytes` of csrc/gru_bwd.cu): up to H = 64
    `walk_smem_floats` (a CTA's rows of Wh beside the full dg), above it
    `walk_wide_smem_floats` (P^T, the tile's rows' partial dh_prev of every
    unit; the Wh slice of the CTA's gate columns; dg's two TF32 halves,
    interleaved). A copy of those layouts; a cuda test holds it to
    the library's at every shape."""
    umax = -(-h_dim // cluster)
    if h_dim > MAX_UNITS:
        k8 = (3 * umax + 7) & ~7
        ldw = ((k8 + 7) & ~15) + 8
        ldx = ((2 * k8 + 15) & ~31) + 16
        return 4 * (rows * (_round16(h_dim) + 4 + ldx) + _round16(h_dim) * ldw)
    nbuf = 2 if cluster > 1 else 1
    return 4 * (nbuf * rows * _mma_ld(3 * h_dim) + _round16(umax) * _mma_ld(3 * h_dim)
                + rows * _THREADS + rows * umax + nbuf * rows * 7 * umax)


def smem_bytes(h_dim: int, rows: int, cluster: int) -> int:
    """The larger of the two recurrence kernels' dynamic shared memory at a
    shape of `launch_shape`, up to H = 64 (`fwd_smem_bytes`,
    `walk_smem_bytes`): a CTA's slice of Wh beside the full h or dg."""
    if h_dim > MAX_UNITS:
        raise ValueError(f"smem_bytes: the shared rule ends at H = {MAX_UNITS}; got {h_dim}")
    return max(fwd_smem_bytes(h_dim, rows, cluster), walk_smem_bytes(h_dim, rows, cluster))


def launch_shape(n_rows: int, h_dim: int, num_sms: int, lanes: int = 1,
                 smem_limit: int = SMEM_PER_BLOCK) -> tuple:
    """(rows per tile, CTAs per cluster) of both recurrence kernels up to H
    = 64 (`fwd_launch_shape`, `walk_launch_shape`), for N rows of each of
    `lanes` models on a card of `num_sms` SMs: the first of 16-row tiles
    alone, 8-row tiles alone, then 16- and 8-row tiles split over 2 and 4
    CTAs, whose grid (tiles of each lane's rows, times the lanes) has a CTA
    for every SM; else the widest split. A cluster never has more CTAs than
    hidden units, a shape whose shared memory exceeds `smem_limit` bytes is
    skipped, and a tile never takes rows of two lanes. This is the rule the
    kernels were tuned under; above H = 64 each kernel has its own."""
    if h_dim > MAX_UNITS:
        raise ValueError(f"launch_shape: the shared rule ends at H = {MAX_UNITS}; got "
                         f"{h_dim} (fwd_launch_shape, walk_launch_shape)")
    shape = None
    for c in CLUSTERS:
        if c > h_dim or c > 4:
            break
        for rows in TILE_ROWS:
            if smem_bytes(h_dim, rows, c) > smem_limit:
                continue
            shape = (rows, c)
            if lanes * -(-n_rows // rows) * c >= num_sms:
                return shape
    return shape


def fwd_clusters(tiles: int, lanes: int, resident: int) -> int:
    """Clusters K1 and the walk above H = 64 give each of `lanes` lanes of
    `tiles` row tiles, `resident` clusters fitting the card at once: an
    equal share of them (at least one), never more than the tiles
    (`wide_clusters` of csrc/gru_common.cuh; the library takes `resident`
    from cudaOccupancyMaxActiveClusters)."""
    return min(tiles, max(1, resident // lanes))


def fwd_resident(h_dim: int, rows: int, cluster: int, num_sms: int,
                 smem_limit: int = SMEM_PER_BLOCK) -> int:
    """Clusters of K1's wide forward resident at once on a card of `num_sms`
    SMs if each SM holds as many CTAs as its shared memory allows: the
    count without a library. The card's own (`gru_fwd_clusters`, from
    cudaOccupancyMaxActiveClusters), which `_fwd_shape` gives the rule, is
    at most this: a cluster's CTAs share a GPC (62 clusters of 4 at H = 128
    on an H100 against 66 here)."""
    return num_sms * (smem_limit // fwd_smem_bytes(h_dim, rows, cluster)) // cluster


def fwd_tiles(cluster_index: int, clusters: int, tiles: int) -> range:
    """The row tiles of one lane that its persistent cluster `cluster_index`
    of `clusters` runs, in order: cluster_index, + clusters, + 2 clusters,
    ... (`wide_tile` of csrc/gru_common.cuh, K1's and the walk's above H =
    64)."""
    return range(cluster_index, tiles, clusters)


def fwd_launch_shape(n_rows: int, h_dim: int, num_sms: int, lanes: int = 1,
                     smem_limit: int = SMEM_PER_BLOCK, resident=None) -> tuple:
    """(rows per tile, CTAs per cluster) of K1, both variants. Up to H = 64
    `launch_shape`'s. Above it the wide forward's: the fewest CTAs that own
    at most WIDE_UNITS units each (4 up to H = 128, 8 up to 256), and of
    FWD_ROWS the tile whose rounds of persistent clusters (`fwd_clusters`,
    with `resident(rows, cluster)` of them resident, by default
    `fwd_resident`) cost least, a step of a tile costing its rows plus
    STEP_FIXED_ROWS; a shape whose shared memory exceeds `smem_limit` bytes
    is skipped. A tile never takes rows of two lanes."""
    if h_dim <= MAX_UNITS:
        return launch_shape(n_rows, h_dim, num_sms, lanes, smem_limit)
    c = next((c for c in CLUSTERS if -(-h_dim // c) <= WIDE_UNITS), None)
    if c is None:
        return None
    if resident is None:
        def resident(rows, cluster):
            return fwd_resident(h_dim, rows, cluster, num_sms, smem_limit)
    best = None
    for rows in FWD_ROWS:
        if fwd_smem_bytes(h_dim, rows, c) > smem_limit:
            continue
        cost = _rounds_cost(n_rows, rows, lanes, max(1, resident(rows, c)), STEP_FIXED_ROWS)
        if best is None or cost < best[0]:
            best = (cost, (rows, c))
    return best[1] if best else None


def _rounds_cost(n_rows: int, rows: int, lanes: int, fit: int, fixed_rows: int) -> int:
    """The cost of a persistent launch of `rows`-row tiles with `fit`
    clusters resident: its rounds of tiles (a cluster's tiles one after
    another, in waves if the lanes' clusters outnumber the resident ones)
    times a step's cost, the tile's rows plus `fixed_rows`."""
    tiles = -(-n_rows // rows)
    per_lane = fwd_clusters(tiles, lanes, fit)
    return -(-tiles // per_lane) * -(-lanes * per_lane // fit) * (rows + fixed_rows)


def walk_shapes(h_dim: int, smem_limit: int = SMEM_PER_BLOCK) -> list:
    """Every (rows, cluster) the walk takes at hidden size h_dim within
    `smem_limit` bytes: up to H = 64 TILE_ROWS over clusters of 1, 2 and 4
    (`launch_shape`'s shapes); above it WALK_ROWS over clusters whose CTAs
    own at most WIDE_UNITS units (`valid_walk_wide_shape` of
    csrc/gru_bwd.cu)."""
    if h_dim <= MAX_UNITS:
        return [(rows, c) for c in CLUSTERS if c <= min(h_dim, 4) for rows in TILE_ROWS
                if smem_bytes(h_dim, rows, c) <= smem_limit]
    return [(rows, c) for c in CLUSTERS if 2 <= c <= h_dim and -(-h_dim // c) <= WIDE_UNITS
            for rows in WALK_ROWS if walk_smem_bytes(h_dim, rows, c) <= smem_limit]


def walk_resident(h_dim: int, rows: int, cluster: int, num_sms: int,
                  smem_limit: int = SMEM_PER_BLOCK) -> int:
    """Clusters of the wide walk resident at once on a card of `num_sms` SMs
    if each SM holds as many CTAs as its shared memory allows: the count
    without a library (the card's own, `gru_walk_clusters`, is at most
    this)."""
    return num_sms * (smem_limit // walk_smem_bytes(h_dim, rows, cluster)) // cluster


def walk_launch_shape(n_rows: int, h_dim: int, num_sms: int, lanes: int = 1,
                      smem_limit: int = SMEM_PER_BLOCK, resident=None) -> tuple:
    """(rows per tile, CTAs per cluster) of the walk. Up to H = 64
    `launch_shape`'s. Above it the wide walk's: the fewest CTAs that own at
    most WIDE_UNITS units each (4 up to H = 128, 8 up to 256), and of
    WALK_ROWS the tile whose rounds of persistent clusters (`fwd_clusters`,
    with `resident(rows, cluster)` of them resident, by default
    `walk_resident`) cost least, a step of a tile costing its rows plus
    WALK_STEP_FIXED_ROWS; a shape whose shared memory exceeds `smem_limit`
    bytes is skipped. A tile never takes rows of two lanes."""
    if h_dim <= MAX_UNITS:
        return launch_shape(n_rows, h_dim, num_sms, lanes, smem_limit)
    c = next((c for c in CLUSTERS if -(-h_dim // c) <= WIDE_UNITS), None)
    if c is None:
        return None
    if resident is None:
        def resident(rows, cluster):
            return walk_resident(h_dim, rows, cluster, num_sms, smem_limit)
    best = None
    for rows in WALK_ROWS:
        if walk_smem_bytes(h_dim, rows, c) > smem_limit:
            continue
        cost = _rounds_cost(n_rows, rows, lanes, max(1, resident(rows, c)),
                            WALK_STEP_FIXED_ROWS)
        if best is None or cost < best[0]:
            best = (cost, (rows, c))
    return best[1] if best else None


@functools.lru_cache(maxsize=None)
def _card(device_index: int) -> tuple:
    """(SMs, shared memory bytes a block may use) of a card."""
    props = torch.cuda.get_device_properties(device_index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_PER_BLOCK))


def _lanes_of(xi: torch.Tensor) -> int:
    return xi.shape[0] if xi.ndim == 4 else 1


def _shape(xi: torch.Tensor) -> tuple:
    """`launch_shape` for xi (N, T, 3H), or lane-axis xi (S, N, T, 3H), on
    the card that holds it (H <= 64)."""
    sms, smem = _card(xi.device.index)
    return launch_shape(xi.shape[-3], xi.shape[-1] // 3, sms, _lanes_of(xi), smem)


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, h_dim: int, rows: int, cluster: int) -> int:
    """Clusters of K1's wide forward a card holds at once at a launch shape
    (`gru_fwd_clusters` of a launch with more tiles than fit)."""
    with torch.cuda.device(device_index):
        return _lib("gru_fwd").gru_fwd_clusters(1 << 20, h_dim, rows, cluster, 1)


def _fwd_shape(xi: torch.Tensor) -> tuple:
    """`fwd_launch_shape` for xi as `_shape`, with the card's own count of
    resident clusters."""
    h_dim = xi.shape[-1] // 3
    sms, smem = _card(xi.device.index)
    return fwd_launch_shape(xi.shape[-3], h_dim, sms, _lanes_of(xi), smem,
                            functools.partial(_resident, xi.device.index, h_dim))


@functools.lru_cache(maxsize=None)
def _walk_resident(device_index: int, h_dim: int, rows: int, cluster: int) -> int:
    """Clusters of the wide walk a card holds at once at a launch shape
    (`gru_walk_clusters` of a launch with more tiles than fit)."""
    with torch.cuda.device(device_index):
        return _lib("gru_bwd").gru_walk_clusters(1 << 20, h_dim, rows, cluster, 1)


def _walk_shape(xi: torch.Tensor) -> tuple:
    """`walk_launch_shape` for xi as `_shape`, with the card's own count of
    resident clusters."""
    h_dim = xi.shape[-1] // 3
    sms, smem = _card(xi.device.index)
    return walk_launch_shape(xi.shape[-3], h_dim, sms, _lanes_of(xi), smem,
                             functools.partial(_walk_resident, xi.device.index, h_dim))


def _gates(x: torch.Tensor, g: torch.Tensor, h_dim: int):
    """r, z, n of one step from xi_t (N, 3H) and g = h . Wh + b (N, 3H)."""
    r = torch.sigmoid(x[:, :h_dim] + g[:, :h_dim])
    z = torch.sigmoid(x[:, h_dim:2 * h_dim] + g[:, h_dim:2 * h_dim])
    n = torch.tanh(x[:, 2 * h_dim:] + r * g[:, 2 * h_dim:])
    return r, z, n


def gru_fwd_plain(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                  keep_residuals: bool = False):
    """xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> last hidden state (N, H);
    with `keep_residuals`, (h, hseq (N, T, H), gseq (N, T, 3H)): h before
    each step and g = h . Wh + b of each step.

    The recurrence written out in PyTorch, gates in torch order [r | z | n]
    as in the TPU kernel: n = tanh(x_n + r * (h . Wh_n + b_n))."""
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    h = torch.zeros((n, h_dim), dtype=xi.dtype, device=xi.device)
    if keep_residuals:
        hseq = xi.new_empty((n, t_len, h_dim))
        gseq = torch.empty_like(xi)
    for t in range(t_len):
        g = h @ w_h + b_h
        if keep_residuals:
            hseq[:, t] = h
            gseq[:, t] = g
        r, z, nn_ = _gates(xi[:, t], g, h_dim)
        h = (1.0 - z) * nn_ + z * h
    return (h, hseq, gseq) if keep_residuals else h


def gru_walk_plain(xi: torch.Tensor, w_h: torch.Tensor, hseq: torch.Tensor,
                   gseq: torch.Tensor, dh: torch.Tensor):
    """The walk t = T-1 .. 0 from the forward's residuals: (dxi (N, T, 3H),
    dgn (N, T, H)), through the hand-derived gate VJP of the TPU kernels'
    `_backward_walk`, carrying dh (N, H)."""
    h_dim = hseq.shape[-1]
    dxi = torch.empty_like(xi)
    dgn = torch.empty_like(hseq)
    for t in range(xi.shape[1] - 1, -1, -1):
        h_prev, g = hseq[:, t], gseq[:, t]
        r, z, nn_ = _gates(xi[:, t], g, h_dim)
        dz = dh * (h_prev - nn_)
        dn = dh * (1.0 - z)
        dtanh = dn * (1.0 - nn_ * nn_)              # d(x_n + r * g_n)
        dr = dtanh * g[:, 2 * h_dim:]
        dghn = dtanh * r
        dghr = dr * r * (1.0 - r)                   # d(x_r + g_r)
        dghz = dz * z * (1.0 - z)                   # d(x_z + g_z)
        dxi[:, t] = torch.cat([dghr, dghz, dtanh], dim=1)
        dgn[:, t] = dghn
        dh = dh * z + torch.cat([dghr, dghz, dghn], dim=1) @ w_h.T
    return dxi, dgn


def gru_dwh_plain(hseq: torch.Tensor, dxi: torch.Tensor, dgn: torch.Tensor):
    """dWh (H, 3H) = sum over rows and steps of h_prev^T . dg, and db (3H,)
    = sum of dg, where dg = [dxi_r | dxi_z | dg_n]."""
    h_dim = hseq.shape[-1]
    dg = torch.cat([dxi[..., :2 * h_dim], dgn], dim=-1).reshape(-1, 3 * h_dim)
    return hseq.reshape(-1, h_dim).T @ dg, dg.sum(dim=0)


def gru_bwd_plain(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                  dh: torch.Tensor, residuals=None):
    """The VJP of `gru_fwd_plain`: (xi, w_h, b_h, dh (N, H)) -> (dxi (N, T,
    3H), dw_h (H, 3H), db_h (3H,)). `residuals` = (hseq, gseq) from
    `gru_fwd_plain(..., keep_residuals=True)`; without them the recurrence
    is run again first (recompute-BPTT)."""
    if residuals is None:
        _, hseq, gseq = gru_fwd_plain(xi, w_h, b_h, keep_residuals=True)
    else:
        hseq, gseq = residuals
    dxi, dgn = gru_walk_plain(xi, w_h, hseq, gseq, dh)
    return (dxi, *gru_dwh_plain(hseq, dxi, dgn))


def _check(name: str, xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
           **more) -> None:
    """xi (N, T, 3H) with its weights, or lane-axis xi (S, N, T, 3H) with
    (S, ...) weights and (S, ...) `more`."""
    if xi.ndim not in (3, 4) or xi.shape[-1] % 3:
        raise ValueError(f"{name}: xi must be (N, T, 3H) or (S, N, T, 3H); got "
                         f"{tuple(xi.shape)}")
    lane = tuple(xi.shape[:-3])
    n, t_len, h3 = xi.shape[-3:]
    h_dim = h3 // 3
    if tuple(w_h.shape) != lane + (h_dim, h3) or tuple(b_h.shape) != lane + (h3,):
        raise ValueError(
            f"{name}: w_h must be {lane + (h_dim, h3)} and b_h {lane + (h3,)}; got "
            f"{tuple(w_h.shape)} and {tuple(b_h.shape)}")
    want = {"dh": lane + (n, h_dim), "hseq": lane + (n, t_len, h_dim),
            "gseq": lane + (n, t_len, h3)}
    tensors = {"xi": xi, "w_h": w_h, "b_h": b_h}
    for key, a in more.items():
        if tuple(a.shape) != want[key]:
            raise ValueError(f"{name}: {key} must be {want[key]}; got {tuple(a.shape)}")
        tensors[key] = a
    _check_device(name, tensors)


def _check_device(name: str, tensors: dict) -> None:
    first = next(iter(tensors.values()))
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors; got {first.device}")
    if first.device.type == "cpu":
        return
    for key, a in tensors.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32; got {a.dtype}")
        if a.device != first.device:
            raise ValueError(f"{name}: {key} is on {a.device}, not {first.device}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gru_fwd": {"gru_fwd": ([_P] * 6 + [_I] * 6 + [_P], _I),
                "gru_fwd_max_hidden": ([], _I),
                "gru_fwd_smem_bytes": ([_I] * 3, _I),
                "gru_fwd_clusters": ([_I] * 5, _I)},
    "gru_bwd": {"gru_walk": ([_P] * 7 + [_I] * 6 + [_P], _I),
                "gru_dwh": ([_P] * 6 + [_L, _I, _I, _P], _I),
                "gru_dwh_scratch_floats": ([_L, _I, _I], _L),
                "gru_bwd_max_hidden": ([], _I),
                "gru_walk_smem_bytes": ([_I] * 3, _I),
                "gru_walk_clusters": ([_I] * 5, _I)},
}


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._typed = True
    return lib


def _check_hidden(name: str, lib, lib_name: str, h_dim: int) -> None:
    cap = getattr(lib, f"{lib_name}_max_hidden")()
    if h_dim > cap:
        raise ValueError(
            f"{name}: hidden size {h_dim} exceeds the kernel's maximum {cap}")


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _raise_if(err: int, name: str, xi_shape, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed at (S, N, T, 3H)={tuple(xi_shape)}, "
                           f"(rows, cluster)={shape}: cudaError {err}")


def _fwd_launch(name: str, xi, w_h, b_h, residuals: bool, shape: tuple):
    """K1 on CUDA tensors at launch shape (rows, cluster): (h, hseq, gseq,
    launched), hseq and gseq None without `residuals`; one model's tensors
    (xi (N, T, 3H)) or S models' (xi (S, N, T, 3H)), the outputs alike.
    Counts nothing."""
    lane = tuple(xi.shape[:-3])
    lanes = xi.shape[0] if lane else 1
    n, t_len, h3 = xi.shape[-3:]
    h_dim = h3 // 3
    lib = _lib("gru_fwd")
    _check_hidden(name, lib, "gru_fwd", h_dim)
    xi, w_h, b_h = xi.contiguous(), w_h.contiguous(), b_h.contiguous()
    out = xi.new_empty(lane + (n, h_dim))
    hseq = gseq = None
    if residuals:
        hseq = xi.new_empty(lane + (n, t_len, h_dim))
        gseq = torch.empty_like(xi)
    if n == 0 or lanes == 0:
        return out, hseq, gseq, False
    with launch_range(name):
        err = lib.gru_fwd(xi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), out.data_ptr(),
                          hseq.data_ptr() if residuals else None,
                          gseq.data_ptr() if residuals else None,
                          n, t_len, h_dim, *shape, lanes, _stream(xi.device))
    _raise_if(err, name, xi.shape, shape)
    return out, hseq, gseq, True


def gru_fwd(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """Fused recurrence: xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> (N, H) f32;
    or S models: xi (S, N, T, 3H), w_h (S, H, 3H), b_h (S, 3H) -> (S, N, H)."""
    xi, w_h, b_h = upcast(xi, w_h, b_h)
    _check("gru_fwd", xi, w_h, b_h)
    if xi.device.type == "cpu":
        return plain(gru_fwd_plain, xi.ndim == 4, xi, w_h, b_h)
    out, _, _, launched = _fwd_launch("gru_fwd", xi, w_h, b_h, False, _fwd_shape(xi))
    gru_fwd.launches += launched
    return out


gru_fwd.launches = 0


@torch.library.custom_op("factorvae_tpu_torch::gru_fwd", mutates_args=())
def gru_fwd_op(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """K1's serving variant as a registered op, the form an exported program
    (`eval/export_aot.py`) calls: on CUDA tensors `gru_fwd` (the kernel,
    counted in `gru_fwd.launches`), on CPU tensors its plain version.
    Shapes as in `gru_fwd`."""
    raise ValueError(f"factorvae_tpu_torch::gru_fwd runs on cuda or cpu tensors; "
                     f"got {xi.device}")


@gru_fwd_op.register_kernel("cuda")
def _gru_fwd_op_cuda(xi, w_h, b_h):
    return gru_fwd(xi, w_h, b_h)


@gru_fwd_op.register_kernel("cpu")
def _gru_fwd_op_cpu(xi, w_h, b_h):
    xi, w_h, b_h = upcast(xi, w_h, b_h)
    _check("gru_fwd", xi, w_h, b_h)
    return plain(gru_fwd_plain, xi.ndim == 4, xi, w_h, b_h)


@gru_fwd_op.register_fake
def _gru_fwd_op_fake(xi, w_h, b_h):
    return xi.new_empty(tuple(xi.shape[:-2]) + (xi.shape[-1] // 3,), dtype=torch.float32)


def gru_fwd_residuals(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor):
    """`gru_fwd` that also returns the residuals of the backward walk: (h
    (N, H), hseq (N, T, H), gseq (N, T, 3H)), h before each step and g =
    h . Wh + b of each step (each with a leading S for S models). The
    kernel's training variant: its h is bitwise `gru_fwd`'s."""
    xi, w_h, b_h = upcast(xi, w_h, b_h)
    _check("gru_fwd_residuals", xi, w_h, b_h)
    if xi.device.type == "cpu":
        return plain(gru_fwd_plain, xi.ndim == 4, xi, w_h, b_h, keep_residuals=True)
    out, hseq, gseq, launched = _fwd_launch("gru_fwd_residuals", xi, w_h, b_h, True,
                                            _fwd_shape(xi))
    gru_fwd_residuals.launches += launched
    return out, hseq, gseq


gru_fwd_residuals.launches = 0


def _dwh_launch(hseq, dxi, dgn):
    """dWh and db on CUDA tensors with N, T > 0, one model's or lane-axis.
    Counts nothing."""
    lane = tuple(hseq.shape[:-3])
    lanes = hseq.shape[0] if lane else 1
    n, t_len, h_dim = hseq.shape[-3:]
    lib = _lib("gru_bwd")
    _check_hidden("gru_dwh", lib, "gru_bwd", h_dim)
    hseq, dxi, dgn = hseq.contiguous(), dxi.contiguous(), dgn.contiguous()
    dw_h = hseq.new_empty(lane + (h_dim, 3 * h_dim))
    db_h = hseq.new_empty(lane + (3 * h_dim,))
    m_rows = n * t_len
    scratch = hseq.new_empty((lib.gru_dwh_scratch_floats(m_rows, h_dim, lanes),))
    with launch_range("gru_dwh"):
        err = lib.gru_dwh(hseq.data_ptr(), dxi.data_ptr(), dgn.data_ptr(), dw_h.data_ptr(),
                          db_h.data_ptr(), scratch.data_ptr(), m_rows, h_dim, lanes,
                          _stream(hseq.device))
    _raise_if(err, "gru_dwh", dxi.shape, None)
    return dw_h, db_h


def gru_dwh(hseq: torch.Tensor, dxi: torch.Tensor, dgn: torch.Tensor):
    """(dWh (H, 3H), db (3H,)) from hseq (N, T, H), dxi (N, T, 3H) and dg_n
    (N, T, H), or each with a leading S for S models: one kernel over all
    N*T rows of each lane into per-block partials, one that sums them in
    block order (deterministic, no atomics)."""
    lane = tuple(hseq.shape[:-3])
    if (hseq.ndim not in (3, 4)
            or tuple(dxi.shape) != tuple(hseq.shape[:-1]) + (3 * hseq.shape[-1],)
            or tuple(dgn.shape) != tuple(hseq.shape)):
        raise ValueError(f"gru_dwh: hseq {tuple(hseq.shape)}, dxi {tuple(dxi.shape)} and "
                         f"dgn {tuple(dgn.shape)} must be {lane}+(N, T, H), (N, T, 3H), "
                         "(N, T, H)")
    _check_device("gru_dwh", {"hseq": hseq, "dxi": dxi, "dgn": dgn})
    if hseq.device.type == "cpu":
        return plain(gru_dwh_plain, hseq.ndim == 4, hseq, dxi, dgn)
    if hseq.numel() == 0:
        h_dim = hseq.shape[-1]
        return (hseq.new_zeros(lane + (h_dim, 3 * h_dim)), hseq.new_zeros(lane + (3 * h_dim,)))
    out = _dwh_launch(hseq, dxi, dgn)
    gru_dwh.launches += 1
    return out


gru_dwh.launches = 0


def _walk_launch(xi, w_h, hseq, gseq, dh, shape: tuple):
    """The walk on checked CUDA tensors with N, T > 0 at launch shape (rows,
    cluster): (dxi (N, T, 3H), dg_n (N, T, H)), or with a leading S for
    lane-axis tensors. Counts nothing."""
    lanes = xi.shape[0] if xi.ndim == 4 else 1
    n, t_len, h3 = xi.shape[-3:]
    h_dim = h3 // 3
    lib = _lib("gru_bwd")
    xi, w_h, dh = xi.contiguous(), w_h.contiguous(), dh.contiguous()
    hseq, gseq = hseq.contiguous(), gseq.contiguous()
    dxi = torch.empty_like(xi)
    dgn = torch.empty_like(hseq)
    with launch_range("gru_bwd"):
        err = lib.gru_walk(xi.data_ptr(), w_h.data_ptr(), hseq.data_ptr(), gseq.data_ptr(),
                           dh.data_ptr(), dxi.data_ptr(), dgn.data_ptr(), n, t_len, h_dim,
                           *shape, lanes, _stream(xi.device))
    _raise_if(err, "gru_bwd", xi.shape, shape)
    return dxi, dgn


def gru_bwd(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor, dh: torch.Tensor,
            *, residuals=None):
    """The recurrence's VJP: (xi (N, T, 3H), w_h (H, 3H), b_h (3H,), dh
    (N, H)) -> (dxi, dw_h, db_h), f32, for any T; each with a leading S for
    S models. `residuals` = (hseq, gseq) from `gru_fwd_residuals`; without
    them one `gru_fwd_residuals` launch makes them. Then the walk (counted
    here) and `gru_dwh`."""
    xi, w_h, b_h, dh = upcast(xi, w_h, b_h, dh)
    more = {"dh": dh}
    if residuals is not None:
        more.update(hseq=residuals[0], gseq=residuals[1])
    _check("gru_bwd", xi, w_h, b_h, **more)
    if xi.device.type == "cpu":
        res = () if residuals is None else tuple(residuals)
        return plain(lambda *a: gru_bwd_plain(*a[:4], residuals=a[4:] or None),
                     xi.ndim == 4, xi, w_h, b_h, dh, *res)
    _check_hidden("gru_bwd", _lib("gru_bwd"), "gru_bwd", xi.shape[-1] // 3)
    if xi.numel() == 0:
        return torch.zeros_like(xi), torch.zeros_like(w_h), torch.zeros_like(b_h)
    if residuals is None:
        _, hseq, gseq = gru_fwd_residuals(xi, w_h, b_h)
    else:
        hseq, gseq = residuals
    dxi, dgn = _walk_launch(xi, w_h, hseq, gseq, dh, _walk_shape(xi))
    gru_bwd.launches += 1
    return (dxi, *gru_dwh(hseq, dxi, dgn))


gru_bwd.launches = 0


class _GRUFunction(torch.autograd.Function):
    """Forward K1 (with `keep_residuals` the residual variant, whose (h,
    hseq, gseq) leave it, hseq and gseq without a gradient), backward the
    walk and dWh. One-model or lane-axis tensors alike; under
    `torch.func.vmap` its rule makes one lane-axis call."""

    @staticmethod
    def forward(xi, w_h, b_h, keep_residuals):
        if not keep_residuals:
            return gru_fwd(xi, w_h, b_h)
        return gru_fwd_residuals(xi, w_h, b_h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xi, w_h, b_h, keep_residuals = inputs
        if keep_residuals:
            _, hseq, gseq = output
            ctx.mark_non_differentiable(hseq, gseq)
            ctx.save_for_backward(xi, w_h, b_h, hseq, gseq)
            # hseq and gseq get no gradient: no zeros are made for them
            ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dh, *_):
        if dh is None:
            return None, None, None, None
        xi, w_h, b_h, hseq, gseq = ctx.saved_tensors
        return (*gru_bwd(xi, w_h, b_h, dh, residuals=(hseq, gseq)), None)

    @staticmethod
    def vmap(info, in_dims, xi, w_h, b_h, keep_residuals):
        xi, w_h, b_h = (lane_major(t, d, info.batch_size)
                        for t, d in zip((xi, w_h, b_h), in_dims[:3]))
        # the wrapped call decided on the batched tensors; decide again on
        # the lane-axis ones, whose requires_grad is autograd's
        keep = torch.is_grad_enabled() and any(a.requires_grad for a in (xi, w_h, b_h))
        out = _GRUFunction.apply(xi, w_h, b_h, keep)
        return (out, (0, 0, 0)) if keep else (out, 0)


def gru(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """Differentiable `gru_fwd`, for one model or S (lane-axis tensors, or a
    `torch.func.vmap` over models). When autograd will need a gradient (grad
    mode on and an input that requires one) the forward is the residual
    variant and the backward walks from its residuals; under `no_grad` or
    `inference_mode` it is the serving variant, and nothing is kept. Under
    `torch.export` it is the op `gru_fwd_op`, so the exported program
    launches K1 where it runs."""
    xi, w_h, b_h = upcast(xi, w_h, b_h)
    if torch.compiler.is_exporting():
        return gru_fwd_op(xi, w_h, b_h)
    keep = torch.is_grad_enabled() and any(a.requires_grad for a in (xi, w_h, b_h))
    out = _GRUFunction.apply(xi, w_h, b_h, keep)
    return out[0] if isinstance(out, tuple) else out
