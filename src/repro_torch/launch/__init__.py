"""Entry points that run a model: the serving steps and the serve loop
(``launch.serve``)."""
