"""The device feature extractor's two hand-written CUDA kernels
(csrc/features_dev.cu): K1 `pcm_frontend_cuda`, one pass over the PCM on a
persistent grid, and K2, the polyphase hann lowpass with its prologues and
epilogues as a grouped launch over a table of stages:
`polyphase_cascade_cuda` runs a stream's whole cascade in one launch
(bands 2 and 3 fused: their CTAs recompute the bottom-2 values they read),
`polyphase_blur_cuda` one stage in one. They replace the XLA device
programs of describealign_tpu/ops/features.py; ops/features.py holds their
plain versions and the dispatch (CPU tensors to the plain versions, CUDA
tensors here).

The stage tables are built here, in Python (`plan_stage`, `stage_table`,
`cascade_table`), so the CPU tests can check what every CTA covers.

Each wrapper checks its inputs, launches on the current stream without
synchronizing, raises if the launch fails, and counts its launches in
`.launches` (under a lock: the batch path's retry launches from pool
threads); the cascade's launches count on `polyphase_blur_cuda`. The
library is built with nvcc at first use.
"""
import ctypes
import functools
import threading

import torch

from .features import CASCADE, ENERGY_BLOCK, FRAME, SMOOTH
from .windows import hann_taps

_lib = None
_taps = {}                      # (device, n_plus_2) -> taps on the device
_sms = {}                       # device -> SM count
_lock = threading.Lock()
EPILOGUES = {None: 0, 'energy': 1, 'band': 2}
BLURS = (3, 13, 15)             # the blurs K2 is built for (the cascade's)
R2 = 9                          # outputs per phase item
K2_THREADS = 256
K2_SMEM_TARGET = 56 * 1024      # shared bytes a K2 CTA aims at


class _Stage(ctypes.Structure):
    """csrc/features_dev.cu's Stage."""
    _fields_ = [('x', ctypes.c_void_p), ('bot', ctypes.c_void_p),
                ('out', ctypes.c_void_p), ('taps', ctypes.c_void_p),
                ('out2', ctypes.c_void_p), ('taps2', ctypes.c_void_p),
                ('taps3', ctypes.c_void_p),
                ('n', ctypes.c_longlong), ('n_out', ctypes.c_longlong),
                ('n_src', ctypes.c_longlong),
                ('ds', ctypes.c_int), ('blur', ctypes.c_int),
                ('r', ctypes.c_int), ('prologue', ctypes.c_int),
                ('epilogue', ctypes.c_int), ('per_block', ctypes.c_int),
                ('first_block', ctypes.c_int), ('n_blocks', ctypes.c_int)]


def load_library():
    """The kernels' ctypes library, built from csrc/features_dev.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        _lib = bind(_load('features_dev', ['features_dev.cu']))
    return _lib


def bind(lib):
    """Declare the C entry points' argument types on a loaded library."""
    lib.pcm_frontend_launch.restype = ctypes.c_int
    lib.pcm_frontend_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    lib.pcm_frontend_config.restype = ctypes.c_int
    lib.pcm_frontend_config.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.polyphase_group_launch.restype = ctypes.c_int
    lib.polyphase_group_launch.argtypes = [
        ctypes.POINTER(_Stage), ctypes.c_int, ctypes.c_void_p]
    return lib


def _device_taps(n_plus_2, device):
    """hann_taps(n_plus_2) as an f32 tensor on the device, made once (a
    host value copied per call would make the dispatching thread wait)."""
    key = (device, n_plus_2)
    with _lock:
        if key not in _taps:
            _taps[key] = torch.from_numpy(hann_taps(n_plus_2)).to(device)
        return _taps[key]


def _sm_count(device):
    with _lock:
        if device not in _sms:
            _sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        return _sms[device]


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


def frontend_config(c, is_i16=True):
    """(ring slots, resident CTAs per SM) of K1 for c channels on the
    current card."""
    slots, per_sm = ctypes.c_int(), ctypes.c_int()
    _check_rc('pcm_frontend', load_library().pcm_frontend_config(
        int(is_i16), c, ctypes.byref(slots), ctypes.byref(per_sm)))
    return slots.value, per_sm.value


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
            bottom.data_ptr(), band.data_ptr(), _sm_count(dev), stream)
    _check_rc('pcm_frontend', rc)
    with _lock:
        pcm_frontend_cuda.launches += 1
    return energy, crossings, bottom, band


pcm_frontend_cuda.launches = 0


def _round4(n):
    return (n + 3) & ~3


def stage_smem_floats(st):
    """Shared f32 words of one stage's CTA (csrc/features_dev.cu's
    stage_smem_floats): taps, the staged input with 3 words of alignment
    slack, the bottom and the prologue's y where there is a prologue, and
    the phase partials (an odd row of ds | 1 words per output)."""
    stride = 2 if st['epilogue'] == 1 else 1
    span_y = st['ds'] * (stride * (st['per_block'] - 1) + st['blur'])
    f = _round4(st['ds'] * st['blur'])
    if st['prologue'] == 3:
        f += (_round4(21) + _round4(15) + _round4(7 * span_y + 14 + 3)
              + 2 * _round4(span_y) + _round4(st['per_block'] + 14)
              + st['per_block'])
    elif st['prologue'] == 0:
        f += _round4(span_y + 3)
    else:
        f += _round4(st['r'] * span_y + 3) + _round4(span_y)
        if st['prologue'] == 1:
            f += _round4(span_y + 3)
    return f + st['per_block'] * (st['ds'] | 1)


def plan_stage(n_x, ds, blur, r=0, bottom=False, epilogue=None):
    """One K2 stage on an input of n_x values (polyphase_blur's arguments;
    `bottom`: whether prologue 1 reads one). The outputs per CTA are R2 x
    a group count: K2_THREADS for ds = 1, else about two rounds of phase
    items over the CTA's threads, halved until the CTA's shared memory is
    within K2_SMEM_TARGET."""
    if blur not in BLURS or ds < 1 or epilogue not in EPILOGUES or (
            epilogue == 'energy' and (ds != 1 or blur != SMOOTH)):
        raise ValueError(f"polyphase_blur: ds={ds}, blur={blur}, epilogue "
                         f"{epilogue!r}: the kernel takes blur in {BLURS} "
                         f"and the energy epilogue at ds 1, blur {SMOOTH}")
    n_y = n_x // r if r else n_x
    st = dict(n_x=n_x, ds=ds, blur=blur, r=r,
              prologue=0 if not r else (1 if bottom else 2),
              epilogue=EPILOGUES[epilogue], n=n_y - n_y % ds, n_src=0)
    st['n_out'] = -(-st['n'] // 2) if epilogue == 'energy' else st['n'] // ds
    return _blocks(st)


def plan_fused_bands(n_bottom1):
    """Prologue 3: bands 2 and 3 off bottom 1 in one stage, each CTA
    recomputing the bottom-2 values its outputs read (its span and a
    halo of 42 + 41 bottom-2 values)."""
    n_src = n_bottom1 - n_bottom1 % CASCADE[1]
    n2 = n_src // CASCADE[1]
    n = n2 - n2 % (FRAME // 35)
    return _blocks(dict(n_x=n_bottom1, ds=FRAME // 35, blur=15, r=CASCADE[1],
                        prologue=3, epilogue=EPILOGUES['band'], n=n,
                        n_src=n_src, n_out=n // (FRAME // 35)))


def _blocks(st):
    """Outputs per CTA and CTA count of a stage."""
    ds = st['ds']
    groups = K2_THREADS if ds == 1 else max(1, 2 * K2_THREADS // ds)
    while True:
        st['per_block'] = R2 * groups
        if groups == 1 or 4 * stage_smem_floats(st) <= K2_SMEM_TARGET:
            break
        groups //= 2
    st['n_blocks'] = -(-st['n_out'] // st['per_block'])
    return st


def stage_table(stages):
    """The stages of one grouped launch with their CTA ranges: stage k
    takes blocks first_block .. first_block + n_blocks - 1, in order."""
    first, table = 0, []
    for st in stages:
        table.append(dict(st, first_block=first))
        first += st['n_blocks']
    return table


@functools.lru_cache(maxsize=64)
def cascade_table(n_energy, n_crossings, n_bottom1, n_band1):
    """A stream's cascade as one grouped launch (a read-only table):
    energy and crossings smoothing and band 1 off K1's outputs, and bands 2
    and 3 off bottom 1 (plan_fused_bands)."""
    return stage_table([plan_stage(n_energy, 1, SMOOTH, epilogue='energy'),
                        plan_stage(n_crossings, 1, SMOOTH),
                        plan_stage(n_band1, FRAME // 5, 15, epilogue='band'),
                        plan_fused_bands(n_bottom1)])


def _stage_array(table, dev):
    """The table as csrc/features_dev.cu's Stage array with its taps on the
    device; the tensors' pointers are set per launch."""
    arr = (_Stage * len(table))()
    for s, st in zip(arr, table):
        s.taps = _device_taps(st['ds'] * st['blur'] + 2, dev).data_ptr()
        if st['prologue'] == 3:
            s.taps2 = _device_taps(CASCADE[1] * 3 + 2, dev).data_ptr()
            s.taps3 = _device_taps(15 + 2, dev).data_ptr()
        for f in ('n', 'n_out', 'n_src', 'ds', 'blur', 'r', 'prologue',
                  'epilogue', 'per_block', 'first_block', 'n_blocks'):
            setattr(s, f, st[f])
    return arr


@functools.lru_cache(maxsize=64)
def _cascade_array(n_energy, n_crossings, n_bottom1, n_band1, dev):
    table = cascade_table(n_energy, n_crossings, n_bottom1, n_band1)
    return table, _stage_array(table, dev)


def _launch_group(table, template, inputs):
    """One grouped K2 launch of `table` (its Stage array `template`, which
    is copied, not written): inputs[k] = (x, bottom or None) of stage k.
    Returns the stages' outputs (two for prologue 3: bands 2 and 3)."""
    dev = inputs[0][0].device
    arr = type(template).from_buffer_copy(template)
    outs = []
    for s, st, (x, bot) in zip(arr, table, inputs):
        out = torch.empty(st['n_out'], dtype=torch.float32, device=dev)
        outs.append(out)
        s.x, s.out = x.data_ptr(), out.data_ptr()
        if bot is not None:
            s.bot = bot.data_ptr()
        if st['prologue'] == 3:
            outs.append(torch.empty_like(out))
            s.out2 = outs[-1].data_ptr()
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.polyphase_group_launch(arr, len(table), stream)
    _check_rc('polyphase_blur', rc)
    with _lock:
        polyphase_blur_cuda.launches += 1
    return outs


def _require_inputs(name, tensors):
    for t in tensors:
        _require_cuda(name, t, (torch.float32,))
        if t.dim() != 1 or t.device != tensors[0].device:
            raise ValueError(f"{name}: expected 1-D tensors on one device")


def polyphase_blur_cuda(x, ds, blur, r=0, bottom=None, epilogue=None):
    """K2 on a 1-D f32 tensor on the card, one stage in one launch; see
    ops/features.polyphase_blur_plain for the arguments."""
    _require_inputs('polyphase_blur', [x] + ([] if bottom is None
                                             else [bottom]))
    st = plan_stage(x.shape[0], ds, blur, r, bottom is not None, epilogue)
    if bottom is not None and (not r or bottom.shape[0] < st['n']):
        raise ValueError(f"polyphase_blur: bottom {tuple(bottom.shape)} "
                         f"for {st['n']} values of the r={r} prologue")
    table = stage_table([st])
    return _launch_group(table, _stage_array(table, x.device),
                         [(x, bottom)])[0]


polyphase_blur_cuda.launches = 0


def polyphase_cascade_cuda(energy, crossings, bottom1, band1):
    """A stream's five feature streams off K1's outputs in one launch; see
    ops/features.polyphase_cascade_plain."""
    _require_inputs('polyphase_cascade', [energy, crossings, bottom1, band1])
    table, template = _cascade_array(energy.shape[0], crossings.shape[0],
                                     bottom1.shape[0], band1.shape[0],
                                     energy.device)
    return tuple(_launch_group(table, template, [
        (energy, None), (crossings, None), (band1, None), (bottom1, None)]))


def feature_work(c, s, dtype_bytes=2):
    """Bytes for one (C, S) stream, as {name: bytes}. 'pcm_frontend': K1
    reads the PCM once and writes its 4 outputs. 'polyphase_blur': the
    least the cascade must move, K1's 4 outputs read once and the 5
    streams written once (the one-launch cascade moves that, halos
    aside)."""
    f32 = 4
    n_e, n_f = s // ENERGY_BLOCK, s // FRAME
    n1 = n_f * FRAME // CASCADE[0]                 # stage-1 outputs
    k1 = c * s * dtype_bytes + (n_e + n_f + 2 * n1) * f32
    k2 = (n_e + n_f + 2 * n1 + -(-n_e // 2) + 4 * n_f) * f32
    return {'pcm_frontend': k1, 'polyphase_blur': k2}
