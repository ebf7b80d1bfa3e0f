"""The worker side of the launcher (the launcher itself: ROADMAP.md L10)."""
