"""End to end: the 95th percentile, over every call of the window, of the
gap on the device's clock between the event recorded after the call before
it and the one recorded after its own last operation, in ms.  With calls
queued this is a call's device time plus any time the device waited for the
host inside the gap; it is not the latency from issue to output."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.gaps_ms, 95)) if ctx.gaps_ms else None
