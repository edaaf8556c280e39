"""Command-line launchers (serve, train, the meta-device dry run), the
production meshes, and the roofline analysis."""
