"""Natural ("OS-style") path sorting - a faithful port of natsort's
os_sorted fallback algorithm (a copy of describealign_tpu/utils/sorting.py).

The reference relies on natsort.os_sorted (describealign.py:119) to define
video<->audio pairing order - the single most safety-critical ordering in
the tool (a divergence silently mis-pairs files). natsort isn't available
in this environment, so this module re-implements the exact key natsort
(8.x) uses on macOS/Linux when PyICU is absent:

    natsort_keygen(alg=ns.PATH | ns.LOCALE | ns.IGNORECASE)

which composes, per input:

1. **Path splitting** (ns.PATH): split into path components from the back
   (stopping at '.'/'..'), then split the final component's extensions off
   one at a time, stopping at an extension that starts with a digit (so
   "file.2.txt" keeps "file.2" whole while "file.tar.gz" splits fully).
2. Per component: NFD unicode normalization; case transform (casefold,
   preceded by swapcase when the locale module is "dumb" - see below);
   split digit runs (\\d+) out as ints; drop empty chunks; "groupletters"
   (interleave each char with its swapcase) + locale.strxfrm on string
   chunks under a dumb locale, plain strxfrm otherwise; guarantee the
   chunk tuple starts with a string (prepend '') so int/str comparisons
   can never collide across keys.

"Dumb" locale = the stdlib locale collates 'A' before 'a'
(locale.strxfrm('A') < locale.strxfrm('a')), which is natsort.compat.
locale.dumb_sort()'s exact probe; the C locale is dumb, most real locales
are not. The behavior is probed at call time, like natsort does.

Pinned against natsort's documented/observed behavior in
tests/test_media_contract.py (adversarial case/extension/unicode cases
including orderings where the pre-round-4 approximation mis-paired).
"""
import locale
import os
import re
import unicodedata

_SPLIT_DIGITS = re.compile(r'(\d+)', re.U)
_NUM_EXT = re.compile(r'\.\d')


def _dumb_locale():
    """natsort.compat.locale.dumb_sort(): stdlib strxfrm that sorts 'A'
    before 'a' can't collate properly, so natsort adds case-grouping
    shims around it."""
    try:
        return locale.strxfrm('A') < locale.strxfrm('a')
    except (locale.Error, OSError):
        return True


def _groupletters(s):
    """natsort.utils.groupletters: interleave swapcase so upper/lower of
    the same letter sort adjacently under a bytewise collation."""
    return ''.join(c.swapcase() + c for c in s)


def _strxfrm(s):
    try:
        return locale.strxfrm(s)
    except (locale.Error, OSError, ValueError):
        return s


def _path_components(s):
    """natsort.utils.path_splitter: path components split from the back,
    final component's extensions peeled one at a time until a numeric
    extension (".2") or no extension remains."""
    parts = []
    path_location = s
    while path_location not in (os.curdir, os.pardir):
        parent_path = path_location
        path_location, child_path = os.path.split(parent_path)
        if path_location == parent_path:
            break
        if child_path:
            parts.append(child_path)
    if path_location:
        parts.append(path_location)
    parts.reverse()
    base = parts.pop() if parts else s
    suffixes = []
    while True:
        front, ext = os.path.splitext(base)
        if not ext or _NUM_EXT.match(ext):
            break
        base = front
        suffixes.append(ext)
    parts.append(base)
    parts.extend(reversed(suffixes))
    return parts


def _component_key(comp, dumb):
    comp = unicodedata.normalize('NFD', comp)
    comp = comp.swapcase().casefold() if dumb else comp.casefold()
    chunks = []
    for i, chunk in enumerate(_SPLIT_DIGITS.split(comp)):
        if not chunk:
            continue
        if i % 2:  # digit run
            try:
                chunks.append(int(chunk))
                continue
            except ValueError:  # exotic \d that int() rejects
                pass
        chunks.append(_strxfrm(_groupletters(chunk)) if dumb
                      else _strxfrm(chunk))
    # natsort's sep_inserter: keys always start with a string chunk and
    # alternate str/int, so same-index chunks always share a type
    if chunks and not isinstance(chunks[0], str):
        chunks.insert(0, _strxfrm(''))
    return tuple(chunks)


def os_sort_key(path):
    """The natsort os_sorted fallback key for one path (tuple of parsed
    path-component tuples)."""
    dumb = _dumb_locale()
    return tuple(_component_key(c, dumb)
                 for c in _path_components(str(path)))


def natural_key(s):
    """Single-key entry used by the GUI file lists; identical semantics to
    os_sort_key (the reference sorts those with natsort too,
    describealign.py:1712)."""
    return os_sort_key(s)


def os_sorted(items):
    """Sort paths the way natsort.os_sorted does without PyICU
    (reference describealign.py:119 pairing order)."""
    return sorted(items, key=os_sort_key)
