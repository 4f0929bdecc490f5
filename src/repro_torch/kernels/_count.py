"""What a kernel wrapper does besides launching its kernel.

``PLAIN_DEVICES`` are the devices on which a wrapper runs its kernel's
plain version: the CPU, and ``meta``, which holds no data and which a
caller asks for to trace shapes (``launch.dryrun``).  On a CUDA tensor a
wrapper launches its kernel or raises.

:func:`counted` marks a wrapper for a work count: while
``utils.cost.count`` runs it sets :data:`recorder`, which then sees
each call with its arguments once (and the ops of the call's body not
at all).  With no count running the wrapper is called as it is.
"""
from __future__ import annotations

import functools

PLAIN_DEVICES = ("cpu", "meta")

# set by utils.cost.count while it counts: recorder(name, fn, args, kw)
# runs ``fn(*args, **kw)`` and returns its result
recorder = None


def kernel_layout(out):
    """The plain version's outputs laid out as the kernel writes its own,
    fresh and contiguous: the ops after a call then see one layout (and
    a work count one step) on every device."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def counted(name: str):
    """Decorate the wrapper of kernel ``name`` for :data:`recorder`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if recorder is None:
                return fn(*args, **kw)
            return recorder(name, fn, args, kw)
        return call
    return wrap
