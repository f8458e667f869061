"""The device feature extractor's two hand-written CUDA kernels
(csrc/features_dev.cu): K1 `pcm_frontend_cuda`, one pass over the PCM, and
K2 `polyphase_blur_cuda`, the polyphase hann lowpass with its prologues
and epilogues. They replace the XLA device programs of
describealign_tpu/ops/features.py; ops/features.py holds their plain
versions (`pcm_frontend_plain`, `polyphase_blur_plain`) and the dispatch
(CPU tensors to the plain versions, CUDA tensors here).

Each wrapper checks its inputs, launches on the current stream without
synchronizing, raises if the launch fails, and counts its launches in
`.launches` (under a lock: the batch path's retry launches from pool
threads). The library is built with nvcc at first use.
"""
import ctypes
import threading

import torch

from .features import CASCADE, ENERGY_BLOCK, FRAME
from .windows import hann_taps

_lib = None
_taps = {}                      # (device, n_plus_2) -> taps on the device
_lock = threading.Lock()
EPILOGUES = {None: 0, 'energy': 1, 'band': 2}


def load_library():
    """The kernels' ctypes library, built from csrc/features_dev.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('features_dev', ['features_dev.cu'])
        lib.pcm_frontend_launch.restype = ctypes.c_int
        lib.pcm_frontend_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_void_p] * 6)
        lib.polyphase_blur_launch.restype = ctypes.c_int
        lib.polyphase_blur_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p])
        _lib = lib
    return _lib


def _device_taps(n_plus_2, device):
    """hann_taps(n_plus_2) as an f32 tensor on the device, made once (a
    host value copied per call would make the dispatching thread wait)."""
    key = (device, n_plus_2)
    with _lock:
        if key not in _taps:
            _taps[key] = torch.from_numpy(hann_taps(n_plus_2)).to(device)
        return _taps[key]


def _require_cuda(name, t, dtypes):
    if t.device.type != 'cuda':
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _check_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def pcm_frontend_cuda(pcm):
    """K1 on (C, S) int16 or f32 PCM on the card. Returns (energy (S // 105,),
    crossings (S // 210,), bottom (S // 210 * 42,), band (likewise)) f32;
    see ops/features.pcm_frontend_plain."""
    _require_cuda('pcm_frontend', pcm, (torch.int16, torch.float32))
    if pcm.dim() != 2:
        raise ValueError(f"pcm_frontend: pcm is {tuple(pcm.shape)}, "
                         f"expected (channels, samples)")
    c, s = pcm.shape
    dev = pcm.device
    n_frames = s // FRAME
    energy = torch.empty(s // ENERGY_BLOCK, dtype=torch.float32, device=dev)
    crossings = torch.empty(n_frames, dtype=torch.float32, device=dev)
    bottom = torch.empty(n_frames * FRAME // CASCADE[0], dtype=torch.float32,
                         device=dev)
    band = torch.empty_like(bottom)
    taps = _device_taps(CASCADE[0] * 3 + 2, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pcm_frontend_launch(
            pcm.data_ptr(), int(pcm.dtype == torch.int16), c, s,
            taps.data_ptr(), energy.data_ptr(), crossings.data_ptr(),
            bottom.data_ptr(), band.data_ptr(), stream)
    _check_rc('pcm_frontend', rc)
    with _lock:
        pcm_frontend_cuda.launches += 1
    return energy, crossings, bottom, band


pcm_frontend_cuda.launches = 0


def polyphase_blur_cuda(x, ds, blur, r=0, bottom=None, epilogue=None):
    """K2 on a 1-D f32 tensor on the card; see
    ops/features.polyphase_blur_plain for the arguments."""
    _require_cuda('polyphase_blur', x, (torch.float32,))
    if bottom is not None:
        _require_cuda('polyphase_blur bottom', bottom, (torch.float32,))
        if bottom.device != x.device:
            raise ValueError("polyphase_blur: bottom and x on other devices")
    if epilogue not in EPILOGUES or (epilogue == 'energy' and ds != 1):
        raise ValueError(f"polyphase_blur: epilogue {epilogue!r} with "
                         f"ds={ds}")
    n_y = x.shape[0] // r if r else x.shape[0]
    if bottom is not None:
        if not r or bottom.shape[0] < n_y:
            raise ValueError(f"polyphase_blur: bottom {tuple(bottom.shape)} "
                             f"for {n_y} outputs of the r={r} prologue")
    n = n_y - n_y % ds
    n_out = -(-n // 2) if epilogue == 'energy' else n // ds
    dev = x.device
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    taps = _device_taps(ds * blur + 2, dev)
    prologue = 0 if not r else (1 if bottom is not None else 2)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.polyphase_blur_launch(
            x.data_ptr(), 0 if bottom is None else bottom.data_ptr(),
            prologue, r, n, ds, taps.data_ptr(), ds * blur,
            EPILOGUES[epilogue], n_out, out.data_ptr(), stream)
    _check_rc('polyphase_blur', rc)
    with _lock:
        polyphase_blur_cuda.launches += 1
    return out


polyphase_blur_cuda.launches = 0


def feature_work(c, s, dtype_bytes=2):
    """Bytes each kernel must move for one (C, S) stream, as {kernel:
    bytes}: K1 reads the PCM once and writes its 4 outputs; the K2 stages
    read their inputs once (x, and bottom for the residual prologue) and
    write their outputs."""
    f32 = 4
    n_e, n_f = s // ENERGY_BLOCK, s // FRAME
    n1 = n_f * FRAME // CASCADE[0]                 # stage-1 outputs
    n2 = n1 // CASCADE[1]                          # bottom2
    k1 = c * s * dtype_bytes + (n_e + n_f + 2 * n1) * f32
    k2 = ((n_e + -(-n_e // 2))                     # energy smoothing
          + 2 * n_f                                # crossings
          + (n1 + n_f)                             # band 1
          + (n1 + n2)                              # bottom 2
          + (n1 + n2 + n_f)                        # band 2 (x, bottom)
          + (n2 + n_f)) * f32                      # band 3
    return {'pcm_frontend': k1, 'polyphase_blur': k2}
