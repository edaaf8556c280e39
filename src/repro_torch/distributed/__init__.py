"""Distribution on ``torch.distributed``: logical-axis sharding rules and
their DTensor placements, sharding specs of parameter, optimizer, batch
and cache trees, the GPipe ring, the straggler-tolerant gradient combine
and the elastic remesh plan, gradient compression with error feedback,
and the checkpoint/restart controller."""
