"""The LC-RWMD serve step (counterpart of ``repro.distributed``), on one
device or over a ``torch.distributed`` mesh: engine-less, monolithic,
segmented and routed."""
