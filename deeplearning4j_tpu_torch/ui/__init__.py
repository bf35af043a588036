from .stats import FileStatsStorage, InMemoryStatsStorage, StatsStorage
