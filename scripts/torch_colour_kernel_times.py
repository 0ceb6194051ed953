#!/usr/bin/env python3
"""Time the port's video-colour kernels (``yuv420_to_bgr``,
``yuv420p10_to_bgr``, ``yuv420_general_to_bgr``,
``yuv420_full_chroma_to_bgr``; ``yuv422_to_bgr``,
``yuv_planar_general_to_bgr``, ``yuv_planar_full_chroma_to_bgr`` and
``gray_to_bgr`` of the other chroma formats; ``packed_to_bgr`` of packed
RGB) on one CUDA card, at the
sizes users' video has, for one checkout of the repository, so that two
checkouts can be compared in turns within one run (parent, change,
change, parent):

    for t in PARENT CHANGE CHANGE PARENT; do
        python3 scripts/torch_colour_kernel_times.py --root $t --label $t
    done

Imports the package of ``--root`` and builds that checkout's kernels.
For each kernel and size (``ROUTES``: the unscaled 8-bit one at 480x640
and 1080x1920; the 10-bit one also at 2160x3840; the 8-bit general one
at 479x640 and 1079x1920; the full-chroma one at 479x639 and 1079x1919,
8-bit, and 480x639, 1080x1919 and 2160x3839, 10-bit; 8-bit 4:2:2 at
480x640, 1080x1920 and 2160x3840; the general planar one on 10-bit
4:2:2 at 480x640, 1080x1920 and 2160x3840, 8-bit 4:4:0 at 1080x1920 and
12-bit 4:2:0 at 2160x3840; the full-chroma planar one on 8-bit 4:4:4 at
480x640, 1080x1920 and 2160x3840 and 10-bit 4:2:2 at 1080x1919; gray at
480x640 (10-bit), 1080x1920 and 2160x3840 (8-bit); packed bgr0 at
480x640, 1080x1920 and 2160x3840 and bgr24 at 1080x1920; a checkout
without a kernel skips it) and turn (0 and 90), on random planes made
from a seed
(chroma left, BT.709 limited at 8 bits, BT.2020 limited above): the
largest difference from the plain version on the card (it must be 0),
and the device ms a launch from ``torch.profiler`` over 200 launches,
warm (back to back on the same planes, which stay
in the 50 MB L2 where they fit) and cold (256 MB written before each
launch), against the bound (the planes read once and the BGR written
once at 3.35 TB/s).  Prints the card's name and power limit, then one
JSON line.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
L2_FLUSH_BYTES = 256 << 20    # written before a cold launch: 5x the L2
# kernel: ((depth, (height, width)[, chroma]), ...), each size one of its
# route; the chroma subsampling as ops.kernels states it (default 4:2:0)
ROUTES = {"yuv420_to_bgr": ((8, (480, 640)), (8, (1080, 1920))),
          "yuv420p10_to_bgr": ((10, (480, 640)), (10, (1080, 1920)),
                               (10, (2160, 3840))),
          "yuv420_general_to_bgr": ((8, (479, 640)), (8, (1079, 1920))),
          "yuv420_full_chroma_to_bgr": ((8, (479, 639)), (8, (1079, 1919)),
                                        (10, (480, 639)), (10, (1080, 1919)),
                                        (10, (2160, 3839))),
          "yuv422_to_bgr": ((8, (480, 640), (1, 0)),
                            (8, (1080, 1920), (1, 0)),
                            (8, (2160, 3840), (1, 0))),
          "yuv_planar_general_to_bgr": ((10, (480, 640), (1, 0)),
                                        (10, (1080, 1920), (1, 0)),
                                        (10, (2160, 3840), (1, 0)),
                                        (8, (1080, 1920), (0, 1)),
                                        (12, (2160, 3840), (1, 1))),
          "yuv_planar_full_chroma_to_bgr": ((8, (480, 640), (0, 0)),
                                            (8, (1080, 1920), (0, 0)),
                                            (8, (2160, 3840), (0, 0)),
                                            (10, (1080, 1919), (1, 0))),
          "gray_to_bgr": ((10, (480, 640), None), (8, (1080, 1920), None),
                          (8, (2160, 3840), None)),
          # packed RGB: the frame's one plane, its format in chroma's place
          "packed_to_bgr": ((8, (480, 640), "bgr0"), (8, (1080, 1920), "bgr0"),
                            (8, (2160, 3840), "bgr0"),
                            (8, (1080, 1920), "bgr24"))}


def device_ms(fn, kernel: str, iters: int) -> float:
    """Device ms a launch of the CUDA kernel whose name holds `kernel`:
    its self device time over the launches torch.profiler recorded in
    `iters` calls of fn (a session with no device event is taken again,
    twice at most)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [(e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(n for n, _ in hits)
        if count:
            if count > iters:
                raise RuntimeError(f"the profiler saw {count} launches of "
                                   f"{kernel} in {iters} calls")
            return sum(us for _, us in hits) / count / 1e3
    raise RuntimeError(f"the profiler saw no launch of {kernel}")


def _calls(kernels, name: str, depth: int, chroma=(1, 1)):
    """(the wrapper, its plain version) of the kernel `name`, each called
    as f(*planes, width=, rotation=, rule=) (chroma left by default)."""
    kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain",
                                                    None)
    planar = {"yuv_planar_general_to_bgr": kernels.general_to_bgr_plain,
              "yuv_planar_full_chroma_to_bgr":
                  kernels.full_chroma_to_bgr_plain}
    if name == "yuv422_to_bgr":
        plain = functools.partial(kernels.yuv420_to_bgr_plain,
                                  chroma=chroma)
    elif name in planar:
        kernel = functools.partial(kernel, depth=depth, chroma=chroma)
        plain = functools.partial(planar[name], depth=depth, chroma=chroma)
    elif name == "gray_to_bgr":
        def kernel(y, **kw):
            kw.pop("rule")
            return kernels.gray_to_bgr(y, depth=depth, **kw)

        def plain(y, **kw):
            kw.pop("rule")
            return kernels.gray_to_bgr_plain(y, depth=depth, **kw)
    elif name == "packed_to_bgr":
        def kernel(y, **kw):
            kw.pop("rule")
            return kernels.packed_to_bgr(y, layout=chroma, **kw)

        def plain(y, **kw):
            kw.pop("rule")
            return kernels.packed_to_bgr_plain(y, layout=chroma, **kw)
    elif name == "yuv420_general_to_bgr":
        plain = functools.partial(kernels.general_to_bgr_plain, depth=8)
    elif name == "yuv420_full_chroma_to_bgr":
        kernel = functools.partial(kernel, depth=depth)
        plain = functools.partial(kernels.full_chroma_to_bgr_plain,
                                  depth=depth)
    return kernel, plain


def colour_kernel_times(dev, routes=ROUTES) -> dict:
    """{kernel: {"HxW D-bit C": {"depth", "bytes", "bound_ms",
    "rotation_T": {...}}}}: the error against the plain version and the
    warm and cold device ms of each turn, with their shares of the
    bound."""
    import torch
    from rtpose_tpu_torch.ops import kernels
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    found = {}
    for name, sizes in routes.items():
        if not hasattr(kernels, name):
            continue
        for depth, (h, w), *chroma in sizes:
            chroma = chroma[0] if chroma else (1, 1)
            matrix = 1 if depth == 8 else 9
            rule = kernels.yuv_rule(matrix, False)
            convert, plain = _calls(kernels, name, depth, chroma)
            dtype = np.uint8 if depth == 8 else np.uint16
            rng = np.random.RandomState(h + depth)
            packed = isinstance(chroma, str)
            shapes = ([(h, kernels.PACKED_BYTES[chroma] * w)] if packed
                      else [(h, w)] if chroma is None else [
                (h, w), *[(-(-h >> chroma[1]), -(-w >> chroma[0]))] * 2])
            planes = [torch.from_numpy(rng.randint(0, 1 << depth, s)
                                       .astype(dtype)).to(dev)
                      for s in shapes]
            n_bytes = sum(p.numel() * p.element_size() for p in planes) \
                + 3 * h * w
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            entry = {"depth": depth, "chroma": chroma, "bytes": n_bytes,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes",
                     "rule": f"matrix {matrix} limited, chroma left"}
            for rot in (0, 90):
                def warm():
                    return convert(*planes, width=w, rotation=rot, rule=rule)

                def cold():
                    flush.zero_()
                    return warm()
                got = warm()
                want = plain(*planes, width=w, rotation=rot, rule=rule)
                err = (int((got.int() - want.int()).abs().max())
                       if got.shape == want.shape else None)
                warm_ms = device_ms(warm, name, 200)
                cold_ms = device_ms(cold, name, 200)
                entry[f"rotation_{rot}"] = dict(
                    max_abs_err=err, device_ms_warm=warm_ms,
                    device_ms_cold=cold_ms,
                    share_of_bound_warm=bound_ms / warm_ms,
                    share_of_bound_cold=bound_ms / cold_ms)
            what = chroma if packed else kernels.CHROMA_NAMES[chroma]
            found.setdefault(name, {})[f"{h}x{w} {depth}-bit {what}"] = entry
    del flush
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))),
        help="checkout whose package to time (default: this one)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_colour_kernel_times: needs a CUDA card")
    from rtpose_tpu_torch.ops import _build, kernels
    if not os.path.abspath(kernels.__file__).startswith(root):
        raise SystemExit(f"{kernels.__file__} is not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load()
    times = colour_kernel_times(torch.device("cuda", 0))
    bad = [(k, s, r) for k, sizes in times.items()
           for s, entry in sizes.items() for r, v in entry.items()
           if r.startswith("rotation_") and v["max_abs_err"] != 0]
    print(json.dumps({"label": args.label, "card": smi, "times": times,
                      "differ_from_plain": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
