"""Environment self-test of the port on a CUDA machine:
``python -m gitax_torch.doctor [--json]``, gitax's doctor made for the
card (gitax/doctor.py).

One line per check, human-readable by default, ``--json`` for a machine
summary (one JSON line); exit 0 when every REQUIRED check passes, 1
otherwise.  pytest cannot run on the card's machine (the tests import
jax), so this is the port's quick self-test there.  The CUDA init, which
can block when a driver or a card is wedged, runs under a watchdog thread
and is reported as a failure instead of hanging the caller.

Checks:
  backend   CUDA init + device enumeration (watchdog-bounded,
            GITAX_TORCH_DOCTOR_BACKEND_TIMEOUT_S, default 60)
  compute   one tiny matmul on the card against the CPU's
  kernels   each hand-written CUDA kernel (gitax_torch/csrc) built and
            launched once at a tiny shape against its plain version
  cache     the kernels' build directory resolvable + writable
  native    what the toolchain offers a native JPEG loader: jpeglib.h
            and -ljpeg, nvjpeg.h and -lnvjpeg, each compiled and linked
            by the CUDA toolkit's nvcc, and whether the port's loader
            (gitax_torch/native, g++ and libjpeg) built (optional: without
            it the port decodes with PIL)
  vocab     bert-base-uncased vocab discoverable (optional: needed only
            for real-checkpoint tokenization)
  tsv       TSV write/read round-trip under a temp dir

`run_checks` takes each check's function, so tests can inject them
(gitax's tests/test_doctor.py, on the CPU).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

TIMEOUT_ENV = "GITAX_TORCH_DOCTOR_BACKEND_TIMEOUT_S"


class Check(object):
    def __init__(self, name, required=True):
        self.name = name
        self.required = required
        self.ok = False
        self.detail = ""
        self.seconds = 0.0

    def run(self, fn):
        t0 = time.time()
        try:
            self.detail = fn() or ""
            self.ok = True
        except Exception as exc:  # noqa: BLE001 — every failure is a report
            self.detail = "{}: {}".format(type(exc).__name__, exc)
            self.ok = False
        self.seconds = time.time() - t0
        return self


def _cuda_devices():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False (torch {}, built for CUDA {})".format(
            torch.__version__, torch.version.cuda))
    torch.cuda.init()
    return ["{} ({})".format(torch.cuda.get_device_name(i), i)
            for i in range(torch.cuda.device_count())]


def _check_backend(timeout_s, init_fn=None):
    """CUDA init under a watchdog: a wedged driver or card can block the
    first CUDA call, so poll from a side thread and report instead of
    hanging.  ``init_fn`` (-> a list of device names) is injectable for
    tests."""
    result = {}

    def init():
        try:
            result["devices"] = (init_fn or _cuda_devices)()
        except Exception as exc:  # noqa: BLE001
            result["error"] = str(exc)

    t = threading.Thread(target=init, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(
            "backend init still blocked after {}s: CUDA driver or card "
            "unreachable?  (CUDA_VISIBLE_DEVICES={})".format(
                timeout_s, os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"))
        )
    if "error" in result:
        raise RuntimeError(result["error"])
    devs = result["devices"]
    return "{} device(s): {}".format(len(devs), ", ".join(devs[:4]))


def _check_compute():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64) / 4096.0
    want = float((x @ x.T).sum())
    got = float((x.cuda() @ x.cuda().T).sum())
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    return "matmul OK on {}".format(torch.cuda.get_device_name(0))


def _kernel_cases():
    """(name, kernel call, plain call, tolerance) of each kernel at a tiny
    shape, on the card."""
    import torch

    from .ops import decode_attention as da
    from .ops import flash_attention as fa
    from .ops import int8_dynamic as i8
    from .ops import vocab_topk as vt

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    b, k, h, dh, m, t = 2, 4, 2, 64, 40, 8
    dec = dict(q=randn(b * k, h * dh), kv_new=randn(b * k, h * 2 * dh),
               txt_kv=randn(t, b * k, h * 2 * dh),
               pos=torch.full((), 3, dtype=torch.int32, device="cuda"), mem_kv=randn(b, h, m, 2 * dh),
               anc=torch.randint(0, k, (b * k, t), generator=g, device="cuda",
                                 dtype=torch.int32))
    kw = dict(beams=k, num_heads=h, head_dim=dh)

    def decode(fn):
        a = dict(dec, txt_kv=dec["txt_kv"].clone())
        return fn(a["q"], a["kv_new"], a["txt_kv"], a["anc"], a["pos"], a["mem_kv"], **kw)

    q, kk, v = (randn(2, 2, 64, dh) for _ in range(3))
    r, w, vocab = 8, 64, 1100
    head_q8 = torch.randint(-127, 128, (vocab, w), generator=g, device="cuda",
                            dtype=torch.int8)
    head = (randn(r, w), head_q8.t(), torch.rand(vocab, generator=g, device="cuda") / 64,
            randn(vocab))
    x8 = randn(24, 64)
    y32 = torch.randint(-2 ** 20, 2 ** 20, (24, 64), generator=g, device="cuda",
                        dtype=torch.int32)
    scales = (torch.rand(24, generator=g, device="cuda"), torch.rand(64, generator=g,
                                                                     device="cuda"))
    cpu = torch.device("cpu")
    return [
        ("decode_attention", lambda: decode(da.decode_attention_cuda),
         lambda: decode(da.decode_attention_reference), 1e-4),
        ("flash_attention", lambda: fa.flash_attention_cuda(q, kk, v, torch.empty_like(q)),
         lambda: fa.attention_reference(q, kk, v), 1e-4),
        ("vocab_topk", lambda: vt.vocab_logits_topk_cuda(*head)[0],
         lambda: vt.vocab_logits_topk_reference(*(a.to(cpu) for a in head))[0], 1e-3),
        ("int8_quantize_rows", lambda: i8.quantize_rows_cuda(x8)[0],
         lambda: i8.quantize_rows_reference(x8)[0], 0.0),
        ("int8_scale_rows", lambda: i8.scale_rows_cuda(y32, *scales, None, torch.float32),
         lambda: i8.scale_rows_reference(y32, *scales, None, torch.float32), 0.0),
    ]


def _check_kernels():
    import torch

    from .ops import cuda_build

    t0 = time.time()
    cuda_build.build_all(["decode_attention", "flash_attention", "vocab_topk", "int8_dynamic"])
    built = time.time() - t0
    worst = {}
    with torch.inference_mode():
        for name, kernel, plain, tol in _kernel_cases():
            got = kernel().float().cpu()
            torch.cuda.synchronize()
            want = plain().float().cpu()
            # equal entries (the -inf past the vocab included) differ by 0
            err = float(torch.where(got == want, 0.0, (got - want).abs()).max())
            scale = float(want[torch.isfinite(want)].abs().max())
            if not err <= tol * max(1.0, scale):
                raise AssertionError("{}: max |kernel - plain| {:.3e}".format(name, err))
            worst[name] = err
    return "built in {:.1f} s; launched against the plain versions: {}".format(
        built, ", ".join("{} {:.1e}".format(n, e) for n, e in worst.items()))


def _check_cache():
    from .ops import cuda_build

    d = str(cuda_build.BUILD_DIR)
    os.makedirs(d, exist_ok=True)
    probe = os.path.join(d, ".doctor_probe_{}".format(os.getpid()))
    with open(probe, "w") as fp:
        fp.write("ok")
    os.remove(probe)
    return d


# header, library, a call that needs both
_NATIVE_PROBES = (
    ("libjpeg", "jpeglib.h", "jpeg",
     "#include <stdio.h>\n#include <jpeglib.h>\n"
     "int main() { struct jpeg_decompress_struct c; struct jpeg_error_mgr e;"
     " c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);"
     " jpeg_destroy_decompress(&c); return 0; }\n"),
    ("nvjpeg", "nvjpeg.h", "nvjpeg",
     "#include <nvjpeg.h>\n"
     "int main() { int v = 0; return nvjpegGetProperty(MAJOR_VERSION, &v) == 0 ? 0 : 1; }\n"),
)


def native_probe(nvcc=None):
    """{'libjpeg': 'found' | 'missing: ...', 'nvjpeg': ...}: whether each
    header compiles and its library links with the CUDA toolkit's nvcc
    (a native loader needs one of them)."""
    from .ops import cuda_build

    nvcc = nvcc or cuda_build.find_nvcc()
    out = {}
    with tempfile.TemporaryDirectory(prefix="gitax_torch_doctor_") as d:
        for name, header, lib, src in _NATIVE_PROBES:
            path = os.path.join(d, name + ".cu")
            with open(path, "w") as fp:
                fp.write(src)
            r = subprocess.run([nvcc, "-Wno-deprecated-gpu-targets", path, "-o",
                                os.path.join(d, name), "-l" + lib],
                               capture_output=True, text=True, timeout=300)
            if r.returncode == 0:
                out[name] = "found ({} and -l{})".format(header, lib)
            else:
                lines = (r.stderr + r.stdout).strip().splitlines()
                errors = [line for line in lines if "error" in line.lower()] or lines
                out[name] = "missing ({} / -l{}: {})".format(
                    header, lib, errors[0].strip() if errors else "exit {}".format(r.returncode))
    return out


def native_loader_line():
    """Whether the port's native loader (`gitax_torch.native`, g++ and
    libjpeg) built, and where it did not, the build log's reason."""
    from . import native

    if native.available():
        return "loader built ({}): use_native=None decodes with it".format(native.so_path().name)
    return "loader not built ({}): use_native=None decodes with PIL".format(
        native.unavailable_reason())


def _check_native():
    probes = native_probe()
    detail = "; ".join("{} {}".format(k, v) for k, v in probes.items())
    detail += "; " + native_loader_line()
    if not any(v.startswith("found") for v in probes.values()):
        raise RuntimeError(detail)
    return detail


def _check_vocab():
    from .tokenization import BertTokenizer

    tok = BertTokenizer.bert_base_uncased()
    return "vocab of {} tokens".format(tok.vocab_size)


def _check_tsv():
    from .io.tsv import TSVFile, tsv_writer

    with tempfile.TemporaryDirectory(prefix="gitax_torch_doctor_") as d:
        p = os.path.join(d, "probe.tsv")
        tsv_writer([("k0", "v0"), ("k1", "v1")], p)
        t = TSVFile(p)
        assert [t[i][1] for i in range(len(t))] == ["v0", "v1"]
    return "write/read round-trip OK"


def run_checks(backend_timeout_s=None, backend_init=None, compute=None, kernels=None,
               native=None):
    """Every check, in order; backend_init (-> device names), compute,
    kernels and native replace the card's checks (the tests inject
    them)."""
    if backend_timeout_s is None:
        try:
            backend_timeout_s = float(os.environ.get(TIMEOUT_ENV, "60"))
        except ValueError:
            backend_timeout_s = 60.0
    checks = [
        Check("backend").run(lambda: _check_backend(backend_timeout_s, backend_init)),
    ]
    # compute and kernels only make sense if the backend came up
    for name, fn in (("compute", compute or _check_compute),
                     ("kernels", kernels or _check_kernels)):
        if checks[0].ok:
            checks.append(Check(name).run(fn))
        else:
            c = Check(name, required=False)  # backend already FAILed
            c.detail = "skipped: backend unavailable"
            checks.append(c)
    checks.append(Check("cache").run(_check_cache))
    checks.append(Check("native", required=False).run(native or _check_native))
    checks.append(Check("vocab", required=False).run(_check_vocab))
    checks.append(Check("tsv").run(_check_tsv))
    return checks


def main(argv=None, **inject):
    """The command line (argv: ['--json'] or []); `inject`: run_checks'
    replacements."""
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    checks = run_checks(**inject)
    failed_required = [c for c in checks if c.required and not c.ok]
    if as_json:
        print(json.dumps({
            "ok": not failed_required,
            "checks": [
                {"name": c.name, "ok": c.ok, "required": c.required,
                 "detail": c.detail, "seconds": round(c.seconds, 2)}
                for c in checks
            ],
        }))
    else:
        for c in checks:
            mark = "OK  " if c.ok else ("warn" if not c.required else "FAIL")
            print("[{}] {:<8} {}  ({:.2f}s)".format(
                mark, c.name, c.detail, c.seconds))
        print("gitax_torch doctor: {}".format(
            "all required checks passed" if not failed_required else
            "{} required check(s) FAILED".format(len(failed_required))))
    return 1 if failed_required else 0


if __name__ == "__main__":
    sys.exit(main())
