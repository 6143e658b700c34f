from .logs import AlignLog, dump_table, logs_to_tuples

__all__ = ["AlignLog", "dump_table", "logs_to_tuples"]
