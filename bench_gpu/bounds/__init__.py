"""One file per hand-written kernel of the port, ``bounds/<kernel>.py``:
``ENTRY`` (``module:function``, the kernel's Python entry, which counts
its ``.launches``), ``PEAK`` (a rate of ``peaks.json``) and
``cost(*args, **kwargs) -> (operations, bytes)`` of one launch from the
entry's own arguments. Each input byte is counted read once and each
output byte written once."""
