"""The card's record of a launch, held against its :class:`~repro_torch.
kernels.launch_meta.LaunchMeta`.

The static metas (``launch_meta``) say what each wrapper launches; this
module reads what the card did: the device's limits through the CUDA
runtime (:func:`device_limits`), each kernel's registers, static shared
memory and spills from the compiler's ``-Xptxas -v`` output
(:func:`compiled_kernels`), and each launch's grid, block, shared memory
and registers from a ``torch.profiler`` trace (:func:`record_launches`).
:func:`hold` compares one recorded launch with its meta.  It runs on a
card only; ``chip_smoke.py`` (phase 25, row (d)) and the card tests use
it.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import tempfile

import torch

from repro_torch.kernels.launch_meta import DeviceLimits, LaunchMeta, SmemMeta

# cudaDeviceAttr values (driver_types.h)
_ATTRS = {"max_threads_per_block": 1, "block_x": 2, "block_y": 3,
          "block_z": 4, "grid_x": 5, "grid_y": 6, "grid_z": 7,
          "static_smem_max": 8, "sms": 16, "max_threads_per_sm": 39,
          "smem_per_sm": 81, "registers_per_sm": 82,
          "smem_per_block_optin": 97, "max_blocks_per_sm": 106,
          "smem_reserved_per_block": 111}


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime PyTorch loaded, else the toolkit's."""
    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            pass
    from torch.utils.cpp_extension import CUDA_HOME
    return ctypes.CDLL(os.path.join(CUDA_HOME or "/usr/local/cuda", "lib64",
                                    "libcudart.so"))


def device_limits(index: int = 0) -> DeviceLimits:
    """The :class:`DeviceLimits` of CUDA device ``index``, read with
    ``cudaDeviceGetAttribute``; the TMA's box and swizzle limits are the
    architecture's and are kept from the defaults."""
    torch.cuda.init()
    fn = _cudart().cudaDeviceGetAttribute
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = {}
    for name, attr in _ATTRS.items():
        value = ctypes.c_int()
        err = fn(ctypes.byref(value), attr, index)
        if err:
            raise RuntimeError(f"cudaDeviceGetAttribute({name}) failed: {err}")
        got[name] = value.value
    return DeviceLimits(
        sms=got["sms"], max_threads_per_block=got["max_threads_per_block"],
        max_block=(got["block_x"], got["block_y"], got["block_z"]),
        max_grid=(got["grid_x"], got["grid_y"], got["grid_z"]),
        smem_per_block_optin=got["smem_per_block_optin"],
        smem_per_sm=got["smem_per_sm"],
        smem_reserved_per_block=got["smem_reserved_per_block"],
        static_smem_max=got["static_smem_max"],
        registers_per_sm=got["registers_per_sm"],
        max_threads_per_sm=got["max_threads_per_sm"],
        max_blocks_per_sm=got["max_blocks_per_sm"])


def kernel_key(name: str) -> str:
    """A demangled kernel name without its return type and parameters:
    ``(anonymous namespace)::flash_decode_split<float, 80, 4>``."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i and (name[i - 1].isalnum()
                                               or name[i - 1] in "_>"):
            return name[:i]
    return name


def _demangle(names: list[str]) -> list[str]:
    from torch.utils.cpp_extension import CUDA_HOME
    tools = [shutil.which("c++filt"),
             os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cu++filt")]
    for tool in tools:
        if tool and os.path.exists(tool):
            out = subprocess.run([tool], input="\n".join(names), text=True,
                                 capture_output=True, check=True, timeout=60)
            return out.stdout.splitlines()
    raise RuntimeError("no demangler (c++filt or cu++filt) found")


def compiled_kernels(log: str) -> dict[str, dict]:
    """``{kernel_key: {"registers", "static_smem", "spill_stores",
    "spill_loads"}}`` of every kernel in a build log of ``nvcc -Xptxas
    -v`` (``runtime.build_log()``)."""
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            found[current] = {"registers": 0, "static_smem": 0,
                              "spill_stores": 0, "spill_loads": 0}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[current]["spill_stores"] = int(m.group(1))
            found[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[current]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found[current]["static_smem"] = int(smem.group(1)) if smem else 0
    names = list(found)
    return {kernel_key(d): found[n] for n, d in zip(names,
                                                   _demangle(names))}


def record_launches(run, compiled: dict[str, dict]):
    """``(run(), launches)``: the kernels of ``compiled`` (this package's,
    :func:`compiled_kernels`) that ``run`` launched, in order, as
    ``torch.profiler`` recorded them (each a chrome-trace event: ``name``
    and ``args`` with ``grid``, ``block``, ``shared memory`` (static plus
    dynamic), ``registers per thread``).  PyTorch's own kernels are left
    out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "kernel"
            and kernel_key(e["name"]) in compiled]
    return out, sorted(ours, key=lambda e: e["ts"])


def resident_blocks(threads: int, registers: int, smem: int,
                    limits: DeviceLimits) -> int:
    """Blocks of this size an SM holds at once, by threads, registers
    (allocated 256 a warp) and shared memory (plus the reserved bytes a
    block): the occupancy calculator's arithmetic."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (limits.registers_per_sm // per_warp // warps if per_warp
               else limits.max_blocks_per_sm)
    by_smem = limits.smem_per_sm // (smem + limits.smem_reserved_per_block)
    return min(limits.max_blocks_per_sm,
               limits.max_threads_per_sm // (warps * 32), by_regs, by_smem)


def hold(meta: LaunchMeta, event: dict, compiled: dict[str, dict],
         limits: DeviceLimits) -> tuple[dict, list[str]]:
    """One recorded launch against its meta: ``(row, problems)``.  The
    grid and the block must equal the meta's, the recorded shared memory
    the meta's dynamic bytes plus the compiler's static bytes, registers
    times threads fit an SM's registers, a cooperative grid fit the blocks
    the card holds at once, and the launch rules
    (``analysis.launch_check``) find nothing under ``limits`` with the
    compiler's static shared memory in place of the declared regions."""
    from repro_torch.analysis.launch_check import check_launch
    args, key = event["args"], kernel_key(event["name"])
    comp = compiled.get(key)
    grid, block = tuple(args["grid"]), tuple(args["block"])
    smem, regs = args["shared memory"], args["registers per thread"]
    row = {"site": meta.site, "kernel": key, "grid": list(grid),
           "block": list(block), "smem": smem,
           "dynamic_smem": meta.dynamic_smem_bytes(),
           "static_smem_declared": meta.static_smem_bytes(),
           "static_smem_compiled": comp and comp["static_smem"],
           "registers": regs, "spill_stores": comp and comp["spill_stores"],
           "spill_loads": comp and comp["spill_loads"],
           "blocks_per_sm_recorded": args.get("blocks per SM")}
    problems = []
    if comp is None:
        return row, [f"{key}: not in the build log"]
    if grid != meta.grid or block != meta.block:
        problems.append(f"grid {grid} block {block} recorded, meta "
                        f"{meta.grid} {meta.block}")
    if smem != meta.dynamic_smem_bytes() + comp["static_smem"]:
        problems.append(f"shared memory {smem} B recorded, meta "
                        f"{meta.dynamic_smem_bytes()} B dynamic + "
                        f"{comp['static_smem']} B static compiled")
    if regs != comp["registers"] or regs * meta.threads > \
            limits.registers_per_sm:
        problems.append(f"{regs} registers recorded ({comp['registers']} "
                        f"compiled) x {meta.threads} threads")
    if meta.cooperative:
        row["resident_blocks_per_sm"] = resident_blocks(meta.threads, regs,
                                                        smem, limits)
        if meta.blocks > limits.sms * row["resident_blocks_per_sm"]:
            problems.append(f"cooperative grid of {meta.blocks} blocks past "
                            f"{row['resident_blocks_per_sm']} an SM")
    compiled_meta = dataclasses.replace(meta, static_smem=(
        SmemMeta("compiled", comp["static_smem"]),))
    problems += [str(f) for f in check_launch(compiled_meta, meta.site,
                                              limits)]
    return row, problems
