"""The LC-RWMD serve step (counterpart of ``repro.distributed``), with the
mesh collapsed to one device."""
