"""Launchers of the port (port of `repro.launch`): the serving engine's
`serve` and the contiguous-cache step builders of `steps`."""
