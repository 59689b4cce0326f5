"""Batched evaluation engine shared by the pair-list benchmarks (MegaDepth
and ScanNet pose, HPatches homography), designed for one CUDA device.

Four stages overlap: image loads on a thread pool, fed from a next-to-load
watermark so each pair is loaded once; one uploader thread that stacks a
batch into pinned host memory and copies it to the device on a stream of
its own, one batch ahead; the batched two-pass match and per-pair sampling
on the main thread's stream; and per-pair estimation on a worker pool,
overlapped with the next batch's matching. The main loop never waits on
the device: the batch's sampled matches go to pinned host memory by one
non-blocking copy ordered by an event, and the worker job that reads a
pair's values waits on that event. The reference runs its benchmarks as
serial per-pair loops, leaving the device idle during every estimator call.

RNG discipline: each pair samples with its own `torch.Generator` on the
matcher's device, seeded from the harness seed and the pair's index in the
unsharded pair list (`pair_generator`), so serial and batched runs draw the
same matches, and a shard draws what the full run draws for its pairs. The
per-pair `finish` hook runs on the main thread in protocol order, so draws
from a shared numpy generator (the shuffle permutations) follow the serial
sequence exactly.

`device_resize=True` ships original-resolution uint8 canvases, each batch
zero-padded to its own largest height and width, and resizes on the device
through PIL-parity interpolation-matrix banks (`RomaMatcher.match_raw`),
one upload serving both model resolutions. Bank rows are cached per
(source size, canvas) pair.

Stage ranges for torch.profiler: `eval.load_wait` (the main thread waiting
for a loaded and uploaded batch), `eval.match`, `eval.sample`, `eval.fetch`.
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from roma_torch.utils.profiling import span

# bank rows kept on the device (per source size and canvas: four matrices
# of at most 864 x 1600 float32 each, ~19 MB at MegaDepth's largest)
BANK_CACHE_ROWS = 64


def estimate_pose_reps(estimate_pose, compute_pose_error, kpts1, kpts2,
                       K1, K2, R, t, norm_threshold, perms) -> list[float]:
    """The shuffled-RANSAC repetitions for one pair (protocol: shuffles
    compose cumulatively, the arrays are reshuffled in place each
    repetition). Thread-safe: pure numpy + the (GIL-releasing) estimator;
    draws no shared RNG (perms are drawn on the main thread in protocol
    order)."""
    errs = []
    for shuffling in perms:
        kpts1, kpts2 = kpts1[shuffling], kpts2[shuffling]
        try:
            ret = estimate_pose(kpts1, kpts2, K1, K2, norm_threshold)
            if ret is None:
                raise ValueError("pose estimation failed")
            R_est, t_est, _mask = ret
            T_est = np.concatenate((R_est, t_est.reshape(3, 1)), axis=-1)
            e_t, e_R = compute_pose_error(T_est, R, t)
            e_pose = max(e_t, e_R)
        except Exception as e:  # noqa: BLE001 - protocol: a failure counts 90 degrees
            print(repr(e))
            e_pose = 90.0
        errs.append(float(e_pose))
    return errs


def pair_generator(seed: int, global_index: int, device) -> torch.Generator:
    """The sampling generator of one pair, on `device`: seeded from the
    harness seed and the pair's index in the unsharded pair list."""
    state = np.random.SeedSequence([seed, global_index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def host_numpy(x) -> np.ndarray:
    """A tensor or an array as a host array (serial paths; syncs on a
    device tensor)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def open_rgb(path) -> Image.Image:
    return Image.open(path).convert("RGB")


class HostSparse:
    """One pair's sampled matches in host memory. `.shape` is known at
    once; the values (`np.asarray`) wait for the batch's device-to-host
    copy, so read them in the worker job, not in `finish`."""

    def __init__(self, host: torch.Tensor, i: int, event):
        self._host, self._i, self._event = host, i, event
        self.shape = tuple(host.shape[1:])

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host[self._i].numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def fetch_to_host(x: torch.Tensor):
    """(host tensor, event | None): one non-blocking copy of a device
    tensor into pinned memory, ordered by an event on the current stream;
    a host tensor as it is."""
    if x.device.type != "cuda":
        return x.detach(), None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class Uploader:
    """Host arrays -> device tensors on a side stream (the CUDA path) or
    host tensors (the CPU path). Runs on one thread; `on_main` hands a
    batch's tensors to the main thread's stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stack(self, arrays, shape=None) -> torch.Tensor:
        """Stack uint8 images into one host tensor (pinned on the CUDA
        path), each zero-padded to `shape` (default: the first one's)."""
        shape = tuple(shape or arrays[0].shape)
        out = torch.zeros((len(arrays), *shape), dtype=torch.uint8,
                          pin_memory=self.stream is not None)
        view = out.numpy()
        for i, a in enumerate(arrays):
            view[(i, *(slice(0, s) for s in a.shape))] = a
        return out

    def to_device(self, host_tensors, make=None):
        """Copy pinned tensors to the device on the side stream, then run
        `make()` (device tensors built from cached rows) there too; returns
        (tensors, made, event)."""
        if self.stream is None:
            return list(host_tensors), (make() if make else None), None
        with torch.cuda.stream(self.stream):
            out = [t.to(self.device, non_blocking=True) for t in host_tensors]
            made = make() if make else None
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, made, event

    @staticmethod
    def on_main(tensors, event):
        """Make the current stream wait for the upload, and tell the caching
        allocator the tensors are used there."""
        if event is None:
            return tensors
        main = torch.cuda.current_stream(tensors[0].device)
        main.wait_event(event)
        for t in tensors:
            t.record_stream(main)
        return tensors


def run_batched_eval(
    matcher,
    items,
    *,
    paths,
    finish,
    sample_num: int,
    batch_size: int = 8,
    workers: int = 8,
    device_resize: bool = False,
    seed: int = 0,
    global_ids=None,
):
    """Run `matcher` over `items` with the batched schedule.

    items: opaque per-pair metadata in protocol (shard-strided) order.
    paths: item -> (path_a, path_b) image paths.
    finish: (index, item, sparse, (w1, h1, w2, h2)) -> (fn, args):
        called on the main thread in item order right after the pair's
        matches are sampled (the place to draw shared RNG); `fn(*args)` then
        runs on the worker pool and its return value is the pair's result.
        `sparse.shape` is immediate; `np.asarray(sparse)` waits for the
        batch's copy to the host: do it inside `fn`, not inside `finish`.
    seed, global_ids: pair i samples with `pair_generator(seed,
        global_ids[i])`; `global_ids` defaults to 0..n-1 (an unsharded
        list).
    Returns the per-pair results in item order.

    Matchers without the batched API (test oracles, Tiny RoMa) fall back
    to per-pair match/sample inside each batch; image loading and
    estimation still overlap.
    """
    if not items:  # empty shard: nothing to schedule
        return []
    n = len(items)
    B = batch_size
    global_ids = list(range(n)) if global_ids is None else list(global_ids)
    cfg = getattr(matcher, "cfg", None)
    fast = (
        hasattr(matcher, "match_prepped")
        and hasattr(matcher, "host_resize_np")
        # duck-typed matchers without a config take the per-pair fallback
        # instead of raising inside loader threads
        and cfg is not None
        and hasattr(cfg, "coarse_resolution")
        and hasattr(cfg, "upsample_preds")
    )
    raw_mode = (
        fast and device_resize
        and hasattr(matcher, "match_raw")
        and hasattr(matcher, "build_resize_banks")
    )
    device = torch.device(getattr(matcher, "device", "cpu")) if fast else torch.device("cpu")
    uploader = Uploader(device)
    bank_rows: OrderedDict = OrderedDict()  # ((h, w), (Hb, Wb)) -> rows; uploader thread only

    def rows_for(size, canvas):
        key = (size, canvas)
        if key in bank_rows:
            bank_rows.move_to_end(key)
        else:
            bank_rows[key] = matcher.build_resize_banks([size], canvas)
            if len(bank_rows) > BANK_CACHE_ROWS:
                bank_rows.popitem(last=False)
        return bank_rows[key]

    def load(item):
        path_a, path_b = paths(item)
        im_a, im_b = open_rgb(path_a), open_rgb(path_b)
        sizes = (*im_a.size, *im_b.size)  # (w1, h1, w2, h2)
        if not fast:
            return (im_a, im_b), sizes
        if raw_mode:
            return (np.asarray(im_a, np.uint8), np.asarray(im_b, np.uint8)), sizes
        # uint8 resizes: normalization happens on the device
        hc, wc = cfg.coarse_resolution
        ims = [matcher.host_resize_np(im, hc, wc) for im in (im_a, im_b)]
        if cfg.upsample_preds:
            hu, wu = cfg.upsample_resolution
            ims += [matcher.host_resize_np(im, hu, wu) for im in (im_a, im_b)]
        return tuple(ims), sizes

    def upload(futs):
        """On the uploader thread: wait for the batch's loads, stack them
        into pinned memory and copy them to the device, so batch k+1's
        transfer overlaps batch k's matching."""
        loaded = [f.result() for f in futs]
        if not fast:
            return loaded, None, None
        if raw_mode:
            ims = [x[0][0] for x in loaded] + [x[0][1] for x in loaded]
            canvas = (max(im.shape[0] for im in ims), max(im.shape[1] for im in ims))
            sizes = sorted({im.shape[:2] for im in ims})
            raw = uploader.stack(ims, (*canvas, 3))
            idx = torch.tensor([sizes.index(im.shape[:2]) for im in ims], dtype=torch.int64)
            if uploader.stream is not None:
                idx = idx.pin_memory()

            def banks():
                rows = [rows_for(s, canvas) for s in sizes]
                return [torch.cat([r[k] for r in rows]) for k in range(len(rows[0]))]

            (raw, idx), made, event = uploader.to_device([raw, idx], banks)
            return loaded, ([raw, idx], made), event
        stacks = [uploader.stack([x[0][k] for x in loaded]) for k in range(len(loaded[0][0]))]
        tensors, _, event = uploader.to_device(stacks)
        return loaded, (tensors, None), event

    results = [None] * n
    with ThreadPoolExecutor(workers) as loaders, \
            ThreadPoolExecutor(1) as upload_pool, \
            ThreadPoolExecutor(workers) as finishers:
        load_futs: dict[int, object] = {}
        next_load = 0  # watermark: items below it have been submitted once

        def ensure_loads(upto):
            nonlocal next_load
            while next_load < min(upto, n):
                load_futs[next_load] = loaders.submit(load, items[next_load])
                next_load += 1

        def submit_upload(start):
            stop = min(start + B, n)
            ensure_loads(stop + 2 * B)
            return upload_pool.submit(upload, [load_futs.pop(j) for j in range(start, stop)])

        result_futs = []
        pending = submit_upload(0)
        for start in range(0, n, B):
            stop = min(start + B, n)
            nb = stop - start
            with span("eval.load_wait"):
                loaded, inputs, event = pending.result()
            if stop < n:
                pending = submit_upload(stop)
            with span("eval.match"):
                if fast:
                    tensors, made = inputs
                    Uploader.on_main(tensors + (made or []), event)
                    if raw_mode:
                        warps, certs = matcher.match_raw(*tensors, tuple(made))
                    else:
                        warps, certs = matcher.match_prepped(*tensors)
                else:
                    outs = [matcher.match(*x[0]) for x in loaded]
                    warps = torch.stack([torch.as_tensor(o[0]) for o in outs])
                    certs = torch.stack([torch.as_tensor(o[1]) for o in outs])
            gens = [pair_generator(seed, global_ids[j], warps.device) for j in range(start, stop)]
            with span("eval.sample"):
                if fast and hasattr(matcher, "sample_batched"):
                    sparse_b = matcher.sample_batched(warps, certs, sample_num, gens)[0]
                else:
                    sparse_b = torch.stack([
                        torch.as_tensor(matcher.sample(warps[i], certs[i], sample_num,
                                                       generator=gens[i])[0])
                        for i in range(nb)
                    ])
            with span("eval.fetch"):
                host, fetched = fetch_to_host(sparse_b)
            for i in range(nb):
                idx = start + i
                fn, fargs = finish(idx, items[idx], HostSparse(host, i, fetched), loaded[i][1])
                result_futs.append((idx, finishers.submit(fn, *fargs)))
        for idx, fut in result_futs:
            results[idx] = fut.result()
    return results
