"""Policy subsystem. The port carries only the name-keyed plug-board
resolution (`registry.resolve`) the binpacker needs; the policy engine
stays behind its default-off switch until it is ported."""
