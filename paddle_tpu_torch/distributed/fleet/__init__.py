"""Fleet (port of ``paddle_tpu.distributed.fleet``, as far as the
launcher needs it): the elastic manager."""
from .elastic import ElasticManager, ElasticStatus  # noqa: F401
