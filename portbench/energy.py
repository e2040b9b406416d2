"""The card's energy counter (NVML ``nvmlDeviceGetTotalEnergyConsumption``,
millijoules since the driver loaded), read through ``ctypes`` on
``libnvidia-ml.so.1``. ``Counter.read()`` gives joules, or None where the
library or the counter cannot be read."""
from __future__ import annotations

import ctypes
from typing import Optional


class Counter:
    def __init__(self, pci_bus_id: str):
        self._lib = None
        self._handle = ctypes.c_void_p()
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
        lib.nvmlShutdown.restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            return
        if lib.nvmlDeviceGetHandleByPciBusId_v2(
                pci_bus_id.encode(), ctypes.byref(self._handle)) != 0:
            lib.nvmlShutdown()
            return
        self._lib = lib

    def read(self) -> Optional[float]:
        if self._lib is None:
            return None
        mj = ctypes.c_ulonglong()
        if self._lib.nvmlDeviceGetTotalEnergyConsumption(
                self._handle, ctypes.byref(mj)) != 0:
            return None
        return mj.value / 1e3

    def close(self):
        if self._lib is not None:
            self._lib.nvmlShutdown()
            self._lib = None


def pci_bus_id(props) -> str:
    """NVML's form of a card's PCI address, from
    ``torch.cuda.get_device_properties``."""
    return (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
            f"{props.pci_device_id:02X}.0")
