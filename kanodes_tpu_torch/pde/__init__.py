"""PDE data, operators and gray-box right-hand sides (port of
`kanodes_tpu/pde/`; the sharded operators wait, ROADMAP.md M16)."""
