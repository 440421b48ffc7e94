"""Launch tools: the trainer (``launch.train``) and the config half of
the roofline model (``launch.roofline``)."""
