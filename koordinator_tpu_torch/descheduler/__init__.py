"""koord-descheduler: the descheduling framework, the LowNodeLoad
balance plugin on the host and its plan on the card (BASELINE config
5). The JAX package's migration controller and compat plugins are not
ported yet."""

from koordinator_tpu_torch.descheduler.framework import (  # noqa: F401
    BalancePlugin,
    CycleRunner,
    DeschedulePlugin,
    EvictionLimiter,
    Evictor,
    RecordingEvictor,
)
from koordinator_tpu_torch.descheduler.lownodeload import (  # noqa: F401
    LowNodeLoadArgs,
    LowNodeLoad,
)
from koordinator_tpu_torch.descheduler.lownodeload_device import (  # noqa
    DeviceLowNodeLoad,
)
