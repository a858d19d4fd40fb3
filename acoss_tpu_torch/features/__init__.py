"""Feature computations on the device (the subset of
`acoss_tpu.features` the ported algorithms use)."""
