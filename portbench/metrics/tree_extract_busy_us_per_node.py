"""The tree family's extract leg: its busy time (``stage["extract"]``,
summed over the threads that ran it) over the forest nodes it wrote into
summaries (``stage["extract_nodes"]``), in microseconds a node; None
where the program keeps no such counter."""


def read(r):
    busy, nodes = r.stage.get("extract"), r.stage.get("extract_nodes")
    return busy * 1e6 / nodes if busy and nodes else None
