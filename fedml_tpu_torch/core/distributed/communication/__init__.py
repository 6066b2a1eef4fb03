"""Transports: the in-process LOCAL broker; pub/sub over the in-tree broker
(Python or C++) or MQTT, with the payload offload to a local, S3 or
content-addressed store (BROKER, MQTT_S3); gRPC (GRPC); and
``torch.distributed.rpc`` (TRPC)."""
