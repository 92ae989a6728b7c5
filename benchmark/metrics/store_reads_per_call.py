"""Host reads of the hit count a call: the program's ``gjkepa.store_read``
spans in the traced sub-window over its calls.  K2's and K13's dispatch
(``ops.fused_epa.face_stores``) takes that read to size a face store in
device memory, only where a tier of the EPA ladder does not fit in shared
memory; each read makes the host wait on the device.  None for a program
without the span (its ``ops.fused_epa`` has no ``STORE_READS`` counter),
and without program spans or device operations."""

import sys

from benchmark.spans import PREFIX, host_ops

SPAN = "gjkepa.store_read"


def read(view):
    epa = sys.modules.get("gjkepa_tpu_torch.ops.fused_epa")
    if not view.device_ops or not hasattr(epa, "STORE_READS"):
        return None
    names = [n for n, _, _ in host_ops(view) if n.startswith(PREFIX)]
    if not names:
        return None
    return names.count(SPAN) / view.calls
