"""Optimizers: msgd, and the parameter-server optimizers that drive a
:class:`~mpit_tpu_torch.optim.client_api.ParamClientAPI`."""

from mpit_tpu_torch.optim.client_api import DeviceSyncAPI, ParamClientAPI
from mpit_tpu_torch.optim.downpour import Downpour
from mpit_tpu_torch.optim.easgd import EAMSGD
from mpit_tpu_torch.optim.msgd import MSGD, MSGDConfig
from mpit_tpu_torch.optim.shells import RuleShell, SingleWorker

__all__ = ["DeviceSyncAPI", "Downpour", "EAMSGD", "MSGD", "MSGDConfig", "ParamClientAPI",
           "RuleShell", "SingleWorker"]
