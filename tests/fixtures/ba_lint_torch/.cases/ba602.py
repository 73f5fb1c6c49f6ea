"""BA602 fixture: metric names at construction sites (parsed, never
run)."""


class _Reg:
    def counter(self, name):
        return name

    def gauge(self, name):
        return name

    def histogram(self, name, base=2.0):
        return name


def build(reg):
    reg.counter("graph_serve_replays_total")  # expect: BA602
    reg.gauge("per_shard_carry_bytes")  # expect: BA602
    reg.histogram("kernel_serve_ms", base=1.0)  # expect: BA602
    reg.histogram("serve_dispatch_s")  # negative: the prefix
    reg.gauge("plane_bytes_per_shard")  # negative: the suffix
    reg.counter("observed_launches")  # negative: 'serve' inside a word
    name = "dyn_serve_gauge"
    reg.gauge(name)  # negative: a dynamic name
